"""Data-parallel FM training with collective mixing (the port of
``hivemall_tpu/parallel/fm_mix.py``).

The mixable FM state is (w0, w[D], V[D, k]): replicas train on their data
shards and mix every ``mix_every`` blocks —

- w: averaged weighted by each replica's per-feature touch marks (every
  FM row updates all its features), like PartialAverage;
- V: averaged with the same per-feature weights broadcast over factors;
- w0: plain mean (every row updates it);
- the adaptive-regularization lambdas are NOT mixed (rank-local, as the
  reference's optimizer state never crossed the MIX wire,
  ref: mix/MixMessage.java:26-95).

One mix is ONE all_reduce of [counts, w * counts, V * counts] and w0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.fm import FMHyper, FMState, init_fm_state, make_fm_step
from .mesh import Mesh, gather_fields, make_mesh, psum
from .mix import MixConfig, grouped_mix_scan, sum_loss


class FMMixTrainer:
    """Data-parallel FM: one replica per rank of ``config.axis_name``;
    ``step`` takes this rank's blocks [k, B, ...] and returns the loss
    summed over the replicas."""

    def __init__(self, hyper: FMHyper, dims: int, mesh: Optional[Mesh] = None,
                 mode: str = "minibatch", config: MixConfig = MixConfig(),
                 mini_batch_average: bool = True):
        self.hyper = hyper
        self.dims = dims
        self.mesh = mesh if mesh is not None else make_mesh()
        self.config = config
        self.axis = config.axis_name
        self.n_dev = self.mesh.shape[self.axis]
        self._local = make_fm_step(hyper, mode,
                                   mini_batch_average=mini_batch_average,
                                   device=self.mesh.device)

    def _mix(self, st: FMState) -> FMState:
        counts = st.touched.float()
        d, kp = st.v.shape
        block = torch.cat([counts[:, None], (st.w * counts)[:, None],
                           st.v * counts[:, None]], dim=1)
        flat = psum(torch.cat([block.reshape(-1), st.w0.reshape(1)]),
                    self.mesh, self.axis)
        block = flat[:-1].reshape(d, 2 + kp)
        total = block[:, 0]
        denom = torch.clamp(total, min=1.0)
        hit = total > 0
        return st.replace(
            w=torch.where(hit, block[:, 1] / denom, st.w),
            v=torch.where(hit[:, None], block[:, 2:] / denom[:, None], st.v),
            w0=flat[-1] / self.n_dev)

    def init(self) -> FMState:
        return init_fm_state(self.dims, self.hyper, device=self.mesh.device)

    def step(self, state: FMState, indices, values, labels, va=None):
        """indices/values/labels: this rank's [k, B, ...] blocks."""
        if va is None:
            va = np.zeros(np.shape(labels), np.float32)
        state, loss = grouped_mix_scan(
            lambda s, blk: self._local(s, *blk), self._mix, state,
            (indices, values, labels, va), self.config.mix_every)
        return state, sum_loss(loss, self.mesh, self.axis)

    def final_state(self, state: FMState) -> FMState:
        """Collapse the replicas into one host model (CPU tensors; a
        collective): w0 / w / V are replica 0's (identical after the
        trailing mix), touched unions, the adaptive-regularization lambdas
        (data-derived scalars, ref: FactorizationMachineModel
        updateLambda* :253-300) average, and step sums."""
        from ..models.fm import fm_state_from_numpy

        h = gather_fields(state, ("w0", "w", "v", "lambda_w0", "lambda_w",
                                  "lambda_v", "touched", "step"),
                          self.mesh, self.axis)
        return fm_state_from_numpy({
            "w0": h["w0"][0], "w": h["w"][0], "v": h["v"][0],
            "lambda_w0": h["lambda_w0"].mean(axis=0),
            "lambda_w": h["lambda_w"].mean(axis=0),
            "lambda_v": h["lambda_v"].mean(axis=0),
            "touched": np.max(h["touched"], axis=0),
            "step": int(h["step"].sum())}, device="cpu")
