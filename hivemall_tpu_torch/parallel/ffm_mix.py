"""Data-parallel FFM training with collective mixing (the port of
``hivemall_tpu/parallel/ffm_mix.py``).

Replicas train on shards, weights cross the "wire", optimizer state stays
local. Mixable FFM state: w0 (mean), w (touch-weighted average), V (plain
mean: the hashed (feature, field) table has no per-entry touch mask, and
entries untouched everywhere are identical across replicas). FTRL's duals
z / n mix with w's touch-weighted average (FTRL derives w from them at the
next update of a feature, so mixing w alone would be overwritten); the
AdaGrad accumulator v_gg stays local. One mix is ONE all_reduce.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.ffm import FFMHyper, FFMState, init_ffm_state, make_ffm_step
from .mesh import Mesh, gather_fields, make_mesh, psum
from .mix import MixConfig, grouped_mix_scan, sum_loss


class FFMMixTrainer:
    """Data-parallel FFM: one replica per rank of ``config.axis_name``;
    ``step`` takes this rank's blocks [k, B, ...]."""

    def __init__(self, hyper: FFMHyper, mesh: Optional[Mesh] = None,
                 mode: str = "minibatch", config: MixConfig = MixConfig()):
        self.hyper = hyper
        self.mesh = mesh if mesh is not None else make_mesh()
        self.config = config
        self.axis = config.axis_name
        self.n_dev = self.mesh.shape[self.axis]
        self._local = make_ffm_step(hyper, mode, device=self.mesh.device)

    def _mix(self, st: FFMState) -> FFMState:
        counts = st.touched.float()
        d = counts.shape[0]
        lin = torch.stack([counts, st.w * counts, st.z * counts,
                           st.n * counts])
        flat = psum(torch.cat([lin.reshape(-1), st.v.reshape(-1),
                               st.w0.reshape(1)]), self.mesh, self.axis)
        total, w, z, n = flat[:4 * d].reshape(4, d)
        hit = total > 0
        denom = torch.clamp(total, min=1.0)
        return st.replace(
            w=torch.where(hit, w / denom, st.w),
            z=torch.where(hit, z / denom, st.z),
            n=torch.where(hit, n / denom, st.n),
            v=flat[4 * d:-1].reshape(st.v.shape) / self.n_dev,
            w0=flat[-1] / self.n_dev)

    def init(self) -> FFMState:
        return init_ffm_state(self.hyper, device=self.mesh.device)

    def step(self, state, indices, values, fields, labels):
        """indices/values/fields/labels: this rank's [k, B, ...] blocks."""
        state, loss = grouped_mix_scan(
            lambda s, blk: self._local(s, *blk), self._mix, state,
            (indices, values, fields, labels), self.config.mix_every)
        return state, sum_loss(loss, self.mesh, self.axis)

    def final_state(self, state) -> FFMState:
        """Collapse the replicas into one host model (CPU tensors; a
        collective): w / z / n / V / w0 are replica 0's (identical after
        the trailing mix), touched unions, the AdaGrad-V accumulator v_gg
        (a sum of squared gradients over each replica's disjoint shard)
        merges by summing, and step sums."""
        from ..models.ffm import ffm_state_from_numpy

        h = gather_fields(state, ("w0", "w", "z", "n", "v", "v_gg",
                                  "touched", "step"), self.mesh, self.axis)
        return ffm_state_from_numpy({
            **{k: h[k][0] for k in ("w0", "w", "z", "n", "v")},
            "v_gg": h["v_gg"].sum(axis=0),
            "touched": np.max(h["touched"], axis=0),
            "step": int(h["step"].sum())}, device="cpu")
