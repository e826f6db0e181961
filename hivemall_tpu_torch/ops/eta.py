"""Learning-rate schedules.

Mirrors hivemall.common.EtaEstimator (ref: core/.../common/EtaEstimator.java:31-160):
fixed, simple (eta0 / (1 + t/total)), inverse-scaling (eta0 / t^power_t), and
the bold-driver "adjusting" estimator from Gemulla et al. KDD'11.

Schedules are pure functions of the example counter `t` (a float32 tensor of
any shape). The factory `get_eta` mirrors the reference's CLI resolution
order (EtaEstimator.get, :128-160).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class EtaEstimator:
    kind: str  # fixed | simple | invscaling | adjusting
    eta0: float = 0.1
    total_steps: float = 10000.0
    power_t: float = 0.1

    def eta(self, t):
        """eta(t) with t the 1-based example counter (float32 tensor)."""
        t = torch.as_tensor(t, dtype=torch.float32)
        if self.kind in ("fixed", "adjusting"):
            # bold driver adjusts from the loss trajectory at iteration
            # boundaries; eta(t) is flat within an iteration
            # (ref: EtaEstimator.java:99-122)
            return torch.full_like(t, self.eta0)
        if self.kind == "simple":
            eta0 = torch.tensor(self.eta0, dtype=t.dtype, device=t.device)
            return torch.where(t > self.total_steps, eta0 / 2,
                               eta0 / (1 + t / self.total_steps))
        if self.kind == "invscaling":
            return self.eta0 / torch.pow(torch.clamp(t, min=1.0), self.power_t)
        raise ValueError(f"unknown eta kind {self.kind}")


def fixed(eta: float) -> EtaEstimator:
    return EtaEstimator("fixed", eta0=eta)


def simple(eta0: float, total_steps: int) -> EtaEstimator:
    return EtaEstimator("simple", eta0=eta0, total_steps=float(total_steps))


def invscaling(eta0: float, power_t: float) -> EtaEstimator:
    return EtaEstimator("invscaling", eta0=eta0, power_t=power_t)


def get_eta(cl=None, default_eta0: float = 0.1) -> EtaEstimator:
    """Resolve schedule from parsed options, mirroring EtaEstimator.get
    (ref: EtaEstimator.java:128-160). `cl` is a utils.options.CommandLine."""
    if cl is None:
        return invscaling(default_eta0, 0.1)
    if cl.has("boldDriver"):
        eta = cl.get_float("eta", 0.3)
        return EtaEstimator("adjusting", eta0=eta)
    if cl.has("eta"):
        return fixed(cl.get_float("eta"))
    eta0 = cl.get_float("eta0", default_eta0)
    if cl.has("t"):
        return simple(eta0, cl.get_int("t"))
    power_t = cl.get_float("power_t", 0.1)
    return invscaling(eta0, power_t)
