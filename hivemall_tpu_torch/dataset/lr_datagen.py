"""`lr_datagen` — synthetic logistic-regression data generator
(ref: dataset/LogisticRegressionDataGeneratorUDTF.java:47-180).

Options mirror the reference: -n_examples/-n_features/-n_dims(200)/-eps/
-prob_one/-seed/-dense/-sort/-cl (classification labels).

`DriftStream` extends the generator into an unbounded event stream with
seeded CONCEPT DRIFT — the workload the continuous-training pipeline
(pipeline/, docs/continuous_training.md) trains against. The
true weight vector rotates piecewise: it is constant within a phase of
``drift_every`` events and rotates by ``drift_angle`` radians at each phase
boundary, inside a 2-plane spanned by two seeded orthonormal directions —
so the concept at any event index is a pure function of ``(seed, index)``
and the whole stream is replayable from any offset (checkpoint resume and
bench rounds see byte-identical data).

A numpy copy of `hivemall_tpu/dataset/lr_datagen.py`: the same seed gives
the same blocks, array for array (the port imports nothing of the JAX
package)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils.options import Options


def _options() -> Options:
    o = Options()
    o.add("n_examples", None, True, "Number of examples [default: 1000]",
          default=1000, type=int)
    o.add("n_features", None, True, "Number of non-zero features per example "
          "[default: 10]", default=10, type=int)
    o.add("n_dims", None, True, "Feature dimension [default: 200]", default=200,
          type=int)
    o.add("eps", None, True, "Label noise epsilon [default: 3.0]", default=3.0,
          type=float)
    o.add("prob_one", "prob_y_1", True, "P(y=1) [default: 0.6]", default=0.6,
          type=float)
    o.add("seed", None, True, "Random seed [default: 43]", default=43, type=int)
    o.add("dense", None, False, "Emit dense feature vectors")
    o.add("sort", None, False, "Sort feature indices in each row")
    o.add("cl", "classification", False, "Emit 0/1 labels instead of probabilities")
    return o


def lr_datagen(options: Optional[str] = None):
    """Returns (features_rows, labels): rows of "idx:value" strings (sparse,
    default) or dense float arrays (-dense)."""
    cl = _options().parse(options, "lr_datagen")
    n = cl.get_int("n_examples", 1000)
    nf = cl.get_int("n_features", 10)
    nd = cl.get_int("n_dims", 200)
    eps = cl.get_float("eps", 3.0)
    prob_one = cl.get_float("prob_one", 0.6)
    rng = np.random.RandomState(cl.get_int("seed", 43))
    dense = cl.has("dense")
    classification = cl.has("cl")

    rows: List = []
    labels = np.empty(n, dtype=np.float32)
    for i in range(n):
        label = prob_one if not classification else float(rng.rand() < prob_one)
        y = label if not classification else label
        labels[i] = y
        sign = 1.0 if (rng.rand() < prob_one) else -1.0
        if classification:
            labels[i] = 1.0 if sign > 0 else 0.0
        else:
            labels[i] = float(rng.rand())
        idx = rng.choice(nd, size=min(nf, nd), replace=False)
        if cl.has("sort"):
            idx = np.sort(idx)
        # feature value correlated with the label plus gaussian noise, the
        # reference's recipe: x ~ N(mu(label), 1) * eps scaling
        mu = 1.0 if labels[i] > 0.5 else -1.0
        vals = (rng.randn(len(idx)) + mu * eps / 3.0).astype(np.float32)
        if dense:
            row = np.zeros(nd, dtype=np.float32)
            row[idx] = vals
            rows.append(row)
        else:
            rows.append([f"{int(j)}:{float(v)}" for j, v in zip(idx, vals)])
    return rows, labels


class DriftStream:
    """Seeded concept-drift event stream: piecewise-rotating true weights.

    ``block(i)`` returns training batch ``i`` as fixed-shape arrays —
    ``(indices [B,K] int32, values [B,K] float32, labels [B] float32 in
    {-1,+1})`` — generated as a pure function of ``(seed, i)``: replaying
    any block after a crash/resume yields identical bytes. Labels follow
    the CURRENT phase's true weight vector (``w_true(phase_of(event))``)
    plus gaussian noise, so a model trained on old phases measurably
    degrades on new ones — the drift the eval gate exists to track.

    ``label_flip_events=(a, b)`` poisons the stream: TRAINING labels of
    events with index in [a, b) come back sign-flipped (``clean_block``
    returns the unflipped truth). This is the deterministic regression
    injector the pipeline bench uses to prove the gate refuses to publish
    a model trained on a bad-data window.

    ``holdout(at_event, n, seed)`` draws fresh rows labeled by the phase
    concept at ``at_event`` — the bench's served-model-quality probe
    (the pipeline's own gate uses a reservoir over OBSERVED events
    instead; pipeline/holdout.py).
    """

    def __init__(self, dims: int, batch: int = 64, width: int = 8, *,
                 seed: int = 42, drift_every: int = 2048,
                 drift_angle: float = 0.35, noise: float = 0.25,
                 label_flip_events: Optional[Tuple[int, int]] = None):
        if dims < 2:
            raise ValueError(f"dims must be >= 2, got {dims}")
        self.dims = int(dims)
        self.batch = int(batch)
        self.width = int(width)
        self.seed = int(seed)
        self.drift_every = int(drift_every)
        self.drift_angle = float(drift_angle)
        self.noise = float(noise)
        self.label_flip_events = label_flip_events
        # two seeded orthonormal directions span the rotation 2-plane; the
        # phase-p concept is u*cos(p*angle) + v*sin(p*angle) — a pure
        # function of p, no cumulative state to drift numerically
        rng = np.random.RandomState(self.seed)
        u = rng.randn(self.dims).astype(np.float32)
        u /= np.linalg.norm(u)
        v = rng.randn(self.dims).astype(np.float32)
        v -= u * np.dot(u, v)
        v /= np.linalg.norm(v)
        self._u, self._v = u, v
        # scale matches bench_chaos's make_stream: unit-normal-ish entries
        self._scale = np.float32(np.sqrt(self.dims))

    def phase_of(self, event_index: int) -> int:
        return int(event_index) // self.drift_every

    def w_true(self, phase: int) -> np.ndarray:
        """The phase-``phase`` concept vector (float32 [dims])."""
        th = np.float32(phase * self.drift_angle)
        return (self._u * np.cos(th) + self._v * np.sin(th)) * self._scale

    def _raw_block(self, i: int):
        b, k = self.batch, self.width
        r = np.random.RandomState((self.seed * 100_003 + i) % (2**31))
        idx = r.randint(0, self.dims, size=(b, k)).astype(np.int32)
        val = r.rand(b, k).astype(np.float32)
        # label each EVENT by the phase it falls in (a block straddling a
        # phase boundary carries both concepts, like real traffic would)
        ev = np.arange(i * b, (i + 1) * b)
        phases = ev // self.drift_every
        margins = np.empty(b, dtype=np.float32)
        for p in np.unique(phases):
            rows = phases == p
            w = self.w_true(int(p))
            margins[rows] = np.sum(w[idx[rows]] * val[rows], axis=-1)
        # label noise RELATIVE to the margin's own scale (std of a width-K
        # dot of unit-variance weights with U(0,1) values is sqrt(K/3)):
        # noise=0.25 keeps the Bayes decision clearly learnable
        margins += (self.noise * np.float32(np.sqrt(self.width / 3.0))
                    * r.randn(b).astype(np.float32))
        lab = np.where(margins > 0, 1.0, -1.0).astype(np.float32)
        return idx, val, lab, ev

    def clean_block(self, i: int):
        """Block ``i`` with TRUE labels (no poison window applied)."""
        idx, val, lab, _ = self._raw_block(i)
        return idx, val, lab

    def block(self, i: int):
        """Block ``i`` as observed: poison-window training labels flipped."""
        idx, val, lab, ev = self._raw_block(i)
        if self.label_flip_events is not None:
            a, b = self.label_flip_events
            lab = np.where((ev >= a) & (ev < b), -lab, lab)
        return idx, val, lab

    def holdout(self, at_event: int, n: int = 2048, seed: int = 999):
        """Fresh labeled rows from the concept at ``at_event``, clean
        labels, pre-parsed per-row form ``(idx_rows, val_rows, labels)``
        — directly scoreable by serving engines. The draw is seeded by
        ``(seed, at_event)``, so repeated probes across a run sample
        different rows while any single (seed, at_event) pair replays
        exactly."""
        r = np.random.RandomState((seed * 1_000_003 + at_event * 7
                                   + self.phase_of(at_event)) % (2**31))
        idx = r.randint(0, self.dims, size=(n, self.width)).astype(np.int64)
        val = r.rand(n, self.width).astype(np.float32)
        w = self.w_true(self.phase_of(at_event))
        lab = np.where(np.sum(w[idx] * val, axis=-1) > 0,
                       1.0, -1.0).astype(np.float32)
        return list(idx), list(val), lab
