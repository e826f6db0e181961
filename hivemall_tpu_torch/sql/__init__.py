from .registry import REGISTRY, get_function, list_functions, macros  # noqa: F401
