"""hivemall_tpu_torch — the PyTorch/CUDA port of hivemall_tpu.

The package mirrors hivemall_tpu's module paths and names so every function
has an obvious counterpart; the JAX package is the reference it is tested
against. It imports torch and numpy only — never jax, flax or hivemall_tpu.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``device.resolve_device``); there is no silent
fallback to the CPU.
"""

from .constants import VERSION

__version__ = VERSION
