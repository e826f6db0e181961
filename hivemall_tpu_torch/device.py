"""Device selection for the port's entry points.

Every entry point (``fit_linear``, ``train_*``, ``make_train_fn`` steps,
the kernel wrappers) runs on the CUDA device unless the caller asks for the
CPU by name. A missing GPU is an error, never a quiet switch to the CPU:
a CPU run measures PyTorch's CPU kernels, not the port.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``, raising ``RuntimeError`` when no
    CUDA device is present; anything else is taken as the caller's explicit
    choice (``"cpu"`` is how the tests run the port)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hivemall_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
