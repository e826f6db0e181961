"""Data-parallel multiclass training with collective mixing (the port of
``hivemall_tpu/parallel/mc_mix.py``).

The reference mixes multiclass learners per label: each label's model
joins MIX group ``jobId + '-' + label`` (ref: LearnerBaseUDTF.java:202-204).
Here the stacked [L, D] tensor mixes in ONE collective, the label axis
riding along:

- average:     w[l, d] = sum_rank(w * touched) / sum_rank(touched)
- argmin_kld:  per (l, d) precision-weighted mean with covariance shrink
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.multiclass import (MCRule, MulticlassState, init_mc_state,
                                 make_mc_train_step)
from .mesh import Mesh, all_gather_host, gather_fields, make_mesh, psum
from .mix import (MixConfig, grouped_mix_scan, merge_slot_arrays,
                  resolve_reduction, sum_loss)


class MulticlassMixTrainer:
    """Data-parallel multiclass: one replica per rank of
    ``config.axis_name``; ``step`` takes this rank's blocks [k, B, ...]
    (labels as label indices)."""

    def __init__(self, rule: MCRule, hyper: dict, num_labels: int, dims: int,
                 mesh: Optional[Mesh] = None, mode: str = "minibatch",
                 config: MixConfig = MixConfig()):
        self.rule = rule
        self.num_labels = num_labels
        self.dims = dims
        self.mesh = mesh if mesh is not None else make_mesh()
        self.config = config
        self.axis = config.axis_name
        self.reduction = resolve_reduction(config.reduction,
                                           rule.use_covariance)
        self._local = make_mc_train_step(rule, hyper, mode,
                                         device=self.mesh.device)

    def _mix(self, st: MulticlassState) -> MulticlassState:
        counts = st.touched.float()  # [L, D]
        if self.reduction == "argmin_kld":
            inv = 1.0 / st.covars
            total, sum_inv, sum_wdiv = psum(
                torch.stack([counts, inv, st.weights * inv]), self.mesh,
                self.axis)
            hit = total > 0
            return st.replace(
                weights=torch.where(hit, sum_wdiv / sum_inv, st.weights),
                covars=torch.where(hit, 1.0 / sum_inv, st.covars))
        total, wsum = psum(torch.stack([counts, st.weights * counts]),
                           self.mesh, self.axis)
        return st.replace(weights=torch.where(
            total > 0, wsum / torch.clamp(total, min=1.0), st.weights))

    def init(self) -> MulticlassState:
        return init_mc_state(self.num_labels, self.dims,
                             self.rule.use_covariance,
                             device=self.mesh.device)

    def step(self, state, indices, values, labels):
        state, loss = grouped_mix_scan(
            lambda s, blk: self._local(s, *blk), self._mix, state,
            (indices, values, labels), self.config.mix_every)
        return state, sum_loss(loss, self.mesh, self.axis)

    def collapse_host(self, host: dict) -> dict:
        """Collapse gathered replicas ([n_dev, ...] numpy fields: weights,
        covars or None, touched, step, slots) into one model's fields:
        weights / covars are replica 0's (identical after the trailing
        mix), touched unions, step sums, and any optimizer slots merge per
        MCRule.slot_merge (merge_slot_arrays) rather than keeping replica
        0's."""
        touched_all = np.asarray(host["touched"])
        out = {"weights": np.asarray(host["weights"])[0],
               "covars": None if host.get("covars") is None
               else np.asarray(host["covars"])[0],
               "touched": np.max(touched_all, axis=0),
               "step": int(np.asarray(host["step"]).sum()), "slots": {}}
        if host.get("slots"):
            out["slots"] = merge_slot_arrays(host["slots"], touched_all,
                                             dict(self.rule.slot_merge))
        return out

    def final_state(self, state) -> MulticlassState:
        """Gather the replicas (a collective) and collapse them
        (`collapse_host`) into one host model (CPU tensors)."""
        from ..models.multiclass import mc_state_from_numpy

        names = ("weights", "touched", "step") + (
            ("covars",) if state.covars is not None else ())
        host = gather_fields(state, names, self.mesh, self.axis)
        host["slots"] = {k: all_gather_host(v, self.mesh, self.axis)
                         for k, v in state.slots.items()}
        merged = self.collapse_host(host)
        out = mc_state_from_numpy(merged, device="cpu")
        return out.replace(slots={k: torch.from_numpy(np.asarray(v))
                                  for k, v in merged["slots"].items()})
