from .checkpoint import (  # noqa: F401
    load_linear_state,
    load_model_rows,
    save_linear_state,
    save_model_rows,
)
