"""The plain reference against the port's trainers on the same tiny rows, on
the CPU (`device="cpu"`: the port's plain torch versions of its kernels).

The port trains in float32 and the reference in float64, so the tables
differ by float32 rounding: both gaps are held to 1e-5, set from float32's
2^-24 unit and a few thousand row updates. The reference's float32 witness
stays as close to the float64 reference on the same rows.
"""

import numpy as np
import pytest

from hivemall_tpu_torch.models.classifier import train_arow, train_scw
from portbench import check, traffic
from portbench.reference import linear, rule

DIMS = 1 << 12
ROW_LAW = {"length": {"law": "poisson", "mean": 9, "min": 1, "max": 16,
                      "seed": 0},
           "ids": {"law": "log_uniform", "placement_seed": 12345},
           "value": 1.0,
           "label": {"law": "planted_logistic", "sigma": 0.5, "bias": 1.0}}
LEARNERS = {"arow": (train_arow, {"r": 0.1}, "-r 0.1"),
            "scw1": (train_scw, {"phi": 1.0, "c": 1.0}, "-phi 1.0 -c 1.0")}


@pytest.mark.parametrize("name", ["arow", "scw1"])
def test_reference_matches_port(name):
    epochs = 3
    rows = traffic.make_rows({"dims": DIMS, "rows": 384, "row_law": ROW_LAW},
                             2 ** 31 + 12345)
    trainer, hyper, opts = LEARNERS[name]
    options = f"-dims {DIMS} {opts} -pallas -iters {epochs} -disable_cv"
    fired = []
    ref_w, ref_cov = linear.exact_fit(
        rows.padded_ids, rows.padded_values, rows.labels, DIMS, epochs,
        rule(name), hyper, fired=fired)
    assert len(fired) == epochs and fired[0].shape == (384,)
    assert 0 < fired[0].sum() <= 384
    model = trainer((rows.ids, rows.values), rows.labels, options,
                    device="cpu")
    got = check.numbers(model.state.weights.double().numpy(),
                        model.state.covars.double().numpy(), ref_w, ref_cov)
    assert got["moved"] > 50
    assert got["w_gap"] < 1e-5 and got["cov_gap"] < 1e-5, got
    wit_w, wit_cov = linear.exact_fit(
        rows.padded_ids, rows.padded_values, rows.labels, DIMS, epochs,
        rule(name), hyper, "float32")
    witness = check.numbers(wit_w, wit_cov, ref_w, ref_cov)
    assert 0 < witness["w_gap"] < 1e-5 and witness["cov_gap"] < 1e-5, witness


def test_distinct_lanes_folds_repeats_and_drops_pads():
    ids = np.array([[3, 5, 3, 9], [4, 9, 9, 9]], np.int64)
    vals = np.array([[1.0, 2.0, 0.5, 0.0], [2.0, 1.0, 1.0, 0.0]], np.float32)
    got = linear.distinct_lanes(ids, vals, 9)
    assert [u.tolist() for u in got[0]] == [[3, 5], [4]]
    assert [s.tolist() for s in got[1]] == [[1.5, 2.0], [2.0]]
    assert [q.tolist() for q in got[2]] == [[1.25, 4.0], [4.0]]


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9, -2.5, 1e-3],
                 np.float32)
    got = linear.to_bf16(x)
    import torch

    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(got, want)
