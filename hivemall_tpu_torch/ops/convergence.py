"""Iteration convergence checking.

Mirrors hivemall.common.ConversionState (ref: core/.../common/ConversionState.java:23-127):
training converges when the relative loss change `(prev - cur) / prev` stays
below `convergence_rate` for TWO consecutive iterations. A loss increase
resets the ready flag. Used by the multi-epoch trainers (FM, MF, epoch-replay
linear learners).

This is host-side control flow between epochs — the per-epoch cumulative loss
is a device scalar pulled once per epoch, so it never stalls a block's step.
"""

from __future__ import annotations

import math


class ConversionState:
    def __init__(self, conversion_check: bool = True, convergence_rate: float = 0.005):
        self.conversion_check = conversion_check
        self.convergence_rate = convergence_rate
        self.ready_to_finish = False
        self.total_errors = 0.0
        self.curr_losses = 0.0
        self.prev_losses = math.inf
        self.cur_iter = 0

    def incr_loss(self, loss: float) -> None:
        self.curr_losses += float(loss)

    def multiply_loss(self, multi: float) -> None:
        self.curr_losses *= multi

    @property
    def cumulative_loss(self) -> float:
        return self.curr_losses

    @property
    def previous_loss(self) -> float:
        return self.prev_losses

    def is_loss_increased(self) -> bool:
        return self.curr_losses > self.prev_losses

    def is_converged(self, observed_examples: int = 0) -> bool:
        self.cur_iter += 1
        if not self.conversion_check:
            self.prev_losses = self.curr_losses
            self.curr_losses = 0.0
            return False
        if self.curr_losses > self.prev_losses:
            self.prev_losses = self.curr_losses
            self.curr_losses = 0.0
            self.ready_to_finish = False
            return False
        change_rate = (self.prev_losses - self.curr_losses) / self.prev_losses
        if change_rate < self.convergence_rate:
            if self.ready_to_finish:
                return True
            self.ready_to_finish = True
        else:
            self.ready_to_finish = False
        self.prev_losses = self.curr_losses
        self.curr_losses = 0.0
        return False


class OnlineVariance:
    """Welford online mean/variance (ref: common/OnlineVariance.java:24)."""

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def handle(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    @property
    def variance(self) -> float:
        return self.m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance)
