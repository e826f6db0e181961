"""torch's TF32 switches, read and set the same way on every torch the port
runs on.

Whether a float32 matmul may run as TF32 has two spellings in torch:

- the legacy ``torch.backends.cuda.matmul.allow_tf32`` flag (which
  ``torch.set_float32_matmul_precision("high")`` also sets), and
- ``fp32_precision`` on ``torch.backends.cuda.matmul``, whose ``"none"``
  inherits the global ``torch.backends.fp32_precision``.

A torch that has the second API keeps both in step when the legacy one is
set, but once the new one has been set, a read of ``allow_tf32`` (or of
``torch.get_float32_matmul_precision()``) raises ``RuntimeError: ... you
have used mix of the legacy and new APIs ...``. So a guard that reads the
legacy flag turns a caller's documented ``fp32_precision = "tf32"`` into
torch's error instead of the guard's own refusal.

`tf32_matmul_enabled` answers for either spelling and never raises: it
reads the new API where torch has it (resolving ``"none"`` to the global
setting) and the legacy flag only on a torch without it. The setters
leave torch's states in step (their docstrings say how). This is the one
module of the port that touches the raw flags: graftcheck's G009 exempts
it, and its ``--fix`` routes other modules' reads and writes here.
"""

from __future__ import annotations

import torch

__all__ = ["refuse_tf32", "set_tf32_cudnn", "set_tf32_matmul",
           "tf32_matmul_enabled"]


def _precision(holder, inherit_from=None) -> str:
    """``holder.fp32_precision`` with ``"none"`` resolved against
    ``inherit_from``; ``""`` on a torch without the new API (its flag
    holders raise AttributeError for a name they do not know)."""
    try:
        prec = holder.fp32_precision
    except AttributeError:
        return ""
    if prec == "none" and inherit_from is not None:
        prec = getattr(inherit_from, "fp32_precision", "none")
    return prec


def tf32_matmul_enabled() -> bool:
    """True when float32 matmuls on the card may run as TF32, however it
    was set: ``allow_tf32``, ``fp32_precision`` (the matmul's own, or the
    global one that its ``"none"`` inherits) or
    ``torch.set_float32_matmul_precision``. Never raises."""
    matmul = torch.backends.cuda.matmul
    prec = _precision(matmul, torch.backends)
    if prec:
        return prec == "tf32"
    return bool(matmul.allow_tf32)


def refuse_tf32(t: torch.Tensor, what: str) -> None:
    """The port's own refusal, for a product that must be true float32:
    raise RuntimeError when ``t`` is on the card and TF32 is on, whichever
    spelling set it. ``what`` opens the message (``"knn batch distances
    compute"``)."""
    if t.is_cuda and tf32_matmul_enabled():
        raise RuntimeError(
            f"{what} in float32: turn TF32 off "
            f"(torch.backends.cuda.matmul.fp32_precision = 'ieee', or "
            f"torch.backends.cuda.matmul.allow_tf32 = False on a torch "
            f"without it): TF32 rounds the product's inputs and breaks "
            f"parity with the reference")


def set_tf32_matmul(enabled: bool) -> None:
    """Allow (or forbid) TF32 for float32 matmuls.

    It goes through ``torch.set_float32_matmul_precision("high")`` /
    ``("highest")``, which on a torch with the new API sets every
    backend's ``fp32_precision`` with the legacy state, from any state the
    two APIs were left in: afterwards every reader agrees — this module,
    a third party's legacy read and ``torch.get_float32_matmul_precision()``,
    which inductor's cache key reads. A write of ``fp32_precision`` or of
    ``allow_tf32`` alone can leave one of those raising."""
    torch.set_float32_matmul_precision("high" if enabled else "highest")


def set_tf32_cudnn(enabled: bool) -> None:
    """Allow (or forbid) TF32 for cuDNN's float32 convolutions and RNNs,
    through the new API where torch has it, which torch advises for cuDNN:
    after a write of the new API, its legacy setter leaves a state in
    which a read of ``cudnn.allow_tf32`` raises."""
    cudnn = torch.backends.cudnn
    holders = [getattr(cudnn, op, None) for op in ("conv", "rnn")]
    holders = [h for h in holders if h is not None and _precision(h)]
    if holders:
        for h in holders:
            h.fp32_precision = "tf32" if enabled else "ieee"
    else:
        cudnn.allow_tf32 = bool(enabled)
