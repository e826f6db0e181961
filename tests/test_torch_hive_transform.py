"""The port's Hive TRANSFORM bridge (hivemall_tpu_torch/adapters/
hive_transform.py) against the JAX package's on the same TSV: subprocess
round trips of both bridges, and every family's emitted rows and
predictions equal (rtol 2e-5 / atol 1e-6; ids, labels and tree programs
exact). The port runs with --device cpu here; without it, and without a
CUDA device, it exits non-zero."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hivemall_tpu.adapters import hive_transform as jbridge
from hivemall_tpu_torch.adapters import hive_transform as tbridge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEM_SEP = "\x02"
RTOL, ATOL = 2e-5, 1e-6
FFM_TOL = (1e-4, 1e-5)  # tests/test_torch_ffm.py's whole-run tolerance


def run_bridge(module, args, stdin_text, check=True, env=None):
    proc = subprocess.run(
        [sys.executable, "-m", f"{module}.adapters.hive_transform", *args],
        input=stdin_text, capture_output=True, text=True, timeout=300,
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})})
    if check:
        assert proc.returncode == 0, proc.stderr
    return proc.stdout


def call_bridge(bridge, args, stdin_text, monkeypatch):
    """The bridge's main() in this process, on the same stdin/stdout
    framing a subprocess gets."""
    out = io.StringIO()
    with monkeypatch.context() as m:
        m.setattr(sys, "stdin", io.StringIO(stdin_text))
        m.setattr(sys, "stdout", out)
        rc = bridge.main(list(args))
    assert rc == 0
    return out.getvalue()


def _rows(text):
    return [line.split("\t") for line in text.splitlines()]


def assert_tsv_match(got, want, tol=(RTOL, ATOL), what=""):
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (rg, rw) in enumerate(zip(g, w)):
        assert len(rg) == len(rw), (what, i)
        for j, (a, b) in enumerate(zip(rg, rw)):
            where = f"{what} row {i} col {j}"
            if a == b:
                continue
            if b.startswith("["):
                np.testing.assert_allclose(json.loads(a), json.loads(b),
                                           *tol, err_msg=where)
            else:
                np.testing.assert_allclose(float(a), float(b), *tol,
                                           err_msg=where)


def _linear_tsv(n=400, dims=64, seed=0, sep=ITEM_SEP):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(dims)
    rows = []
    for _ in range(n):
        idx = rng.choice(dims, size=6, replace=False)
        rows.append((idx, 1.0 if w_true[idx].sum() > 0 else -1.0))
    train = "".join(sep.join(f"{j}:1" for j in idx) + f"\t{y}\n"
                    for idx, y in rows)
    test = "".join(f"r{i}\t" + sep.join(f"{j}:1" for j in idx) + "\n"
                   for i, (idx, _) in enumerate(rows[:80]))
    return train, test


def test_train_arow_round_trips_of_both_bridges(tmp_path):
    """Both bridges as subprocesses on one TSV: the emitted model rows and
    the predict_linear scores over them are the same."""
    train, test = _linear_tsv()
    args = ["train_arow", "-dims", "64"]
    got = run_bridge("hivemall_tpu_torch", args + ["--device", "cpu"], train)
    want = run_bridge("hivemall_tpu", args, train)
    assert_tsv_match(got, want, what="train_arow rows")
    assert all(len(r) == 3 for r in _rows(got))
    preds = []
    for module, rows in (("hivemall_tpu_torch", got), ("hivemall_tpu", want)):
        path = tmp_path / f"{module}.tsv"
        path.write_text(rows)
        preds.append(run_bridge(module, ["predict_linear", "-loadmodel",
                                         str(path), "-sigmoid"], test))
    assert_tsv_match(preds[0], preds[1], what="predict_linear")
    assert [r[0] for r in _rows(preds[0])] == [f"r{i}" for i in range(80)]


def _dense_tsv(X, y, fmt="{:d}"):
    return "".join(ITEM_SEP.join(f"{v:.6f}" for v in X[i]) + "\t"
                   + fmt.format(y[i]) + "\n" for i in range(len(y)))


def _mc_tsv(seed):
    rng = np.random.RandomState(seed)
    rows, labels = [], []
    for _ in range(240):
        c = rng.randint(3)
        idx = [c * 8 + int(j) for j in rng.choice(8, size=3, replace=False)]
        rows.append(ITEM_SEP.join(f"{j}:1" for j in idx))
        labels.append(f"class{c}")
    return ("".join(f"{r}\t{lab}\n" for r, lab in zip(rows, labels)),
            "".join(f"r{i}\t{r}\n" for i, r in enumerate(rows[:60])))


def _ffm_tsv(seed):
    rng = np.random.RandomState(seed)
    rows, labels = [], []
    for _ in range(200):
        idx = rng.choice(32, size=5, replace=False)
        rows.append(ITEM_SEP.join(f"{j % 4}:{j}:1" for j in idx))
        labels.append(1.0 if idx.sum() > 75 else -1.0)
    return ("".join(f"{r}\t{y}\n" for r, y in zip(rows, labels)),
            "".join(f"{i}\t{r}\n" for i, r in enumerate(rows[:40])))


def _forest_tsv(seed, labels=(0, 1)):
    rng = np.random.RandomState(seed)
    X = rng.rand(240, 5)
    y = np.where(X[:, 0] > 0.5, labels[1], labels[0])
    test = "".join(f"r{i}\t" + ITEM_SEP.join(f"{v:.6f}" for v in X[i])
                   + "\n" for i in range(80))
    return _dense_tsv(X, y), test


def _case_linear():
    train, test = _linear_tsv(n=200, seed=1, sep=" ")
    # NULL feature / NULL label rows are skipped, as the UDTF does
    return (["train_perceptron", "-dims", "64"],
            "\\N\t1.0\n0:1 1:1\t\\N\n" + train, ["predict_linear"], test)


FAMILIES = {
    "perceptron": _case_linear,
    "arow_pallas": lambda: (["train_arow", "-dims", "64", "-pallas"],
                            *(_linear_tsv(seed=2)[:1]), ["predict_linear"],
                            _linear_tsv(seed=2)[1]),
    "fm": lambda: (["train_fm", "-dims", "64", "-factors", "4",
                    "-classification", "-iters", "2"],
                   _linear_tsv(n=300, seed=3)[0], ["predict_fm"],
                   _linear_tsv(n=300, seed=3)[1]),
    "ffm": lambda: (["train_ffm", "-feature_hashing", "8", "-factors", "3"],
                    _ffm_tsv(11)[0], ["predict_ffm"], _ffm_tsv(11)[1]),
    "multiclass": lambda: (["train_multiclass_arow", "-dims", "24"],
                           _mc_tsv(6)[0], ["predict_multiclass"],
                           _mc_tsv(6)[1]),
    "forest": lambda: (["train_randomforest_classifier", "-trees", "6",
                        "-seed", "3"], *_forest_tsv(8)[:1],
                       ["predict_forest"], _forest_tsv(8)[1]),
    "gbt": lambda: (["train_gradient_tree_boosting_classifier", "-trees",
                     "4", "-iters", "4", "-seed", "5"],
                    _forest_tsv(14, (-1, 1))[0], ["predict_gbt"],
                    _forest_tsv(14, (-1, 1))[1]),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_rows_and_predictions_equal_jax(family, tmp_path,
                                               monkeypatch):
    """Both bridges' main() on the same TSV: emitted rows equal, and each
    bridge's predict subcommand over its own rows scores the same."""
    train_args, train, predict_args, test = FAMILIES[family]()
    got = call_bridge(tbridge, train_args + ["--device=cpu"], train,
                      monkeypatch)
    want = call_bridge(jbridge, train_args, train, monkeypatch)
    tol = FFM_TOL if family == "ffm" else (RTOL, ATOL)
    if family == "ffm":
        # the -2 row is the whole model's half-float blob: held below by
        # the scores each bridge's predict_ffm gives from it
        keep = lambda t: "".join(  # noqa: E731
            line + "\n" for line in t.splitlines() if not
            line.startswith("-2\t"))
        assert_tsv_match(keep(got), keep(want), tol, f"{family} rows")
    else:
        assert_tsv_match(got, want, tol, f"{family} rows")
    preds = []
    for bridge, rows, extra in ((tbridge, got, ["--device", "cpu"]),
                                (jbridge, want, [])):
        path = tmp_path / f"{bridge.__name__}.tsv"
        path.write_text(rows)
        preds.append(call_bridge(bridge, predict_args + ["-loadmodel",
                                                         str(path)] + extra,
                                 test, monkeypatch))
    if family == "ffm":  # each package's blob, half floats rounded apart
        assert_tsv_match(preds[0], preds[1], (5e-3, 5e-3), "predict_ffm")
        # the JAX blob through the port's predict_ffm == through JAX's
        cross = call_bridge(tbridge, ["predict_ffm", "-loadmodel",
                                      str(tmp_path / f"{jbridge.__name__}"
                                          ".tsv"), "--device", "cpu"],
                            test, monkeypatch)
        assert_tsv_match(cross, preds[1], what="predict_ffm of JAX's blob")
    else:
        assert_tsv_match(preds[0], preds[1], what=f"{family} predictions")
    assert len(_rows(preds[0])) == len(test.splitlines())


def test_mf_emission_equals_jax(monkeypatch):
    rng = np.random.RandomState(5)
    users = rng.randint(0, 20, size=300)
    items = rng.randint(0, 15, size=300)
    ratings = rng.rand(300) * 5
    text = "".join(f"{u}\t{i}\t{r:.4f}\n"
                   for u, i, r in zip(users, items, ratings))
    args = ["train_mf_sgd", "-factor", "4", "-iterations", "3"]
    got = call_bridge(tbridge, args + ["--device", "cpu"], text, monkeypatch)
    want = call_bridge(jbridge, args, text, monkeypatch)
    assert_tsv_match(got, want, what="mf rows")
    assert all(len(r) == 6 for r in _rows(got))


def test_port_bridge_subprocess_fm_round_trip(tmp_path, monkeypatch):
    """train_fm and predict_fm through the port's bridge as subprocesses
    equal the JAX bridge's on the same TSV."""
    train, test = _linear_tsv(n=300, seed=3)
    args = ["train_fm", "-dims", "64", "-factors", "4", "-classification",
            "-iters", "2"]
    got = run_bridge("hivemall_tpu_torch", ["--device", "cpu"] + args, train)
    want = call_bridge(jbridge, args, train, monkeypatch)
    assert_tsv_match(got, want, what="train_fm rows")
    path = tmp_path / "fm.tsv"
    path.write_text(got)
    pred = run_bridge("hivemall_tpu_torch",
                      ["predict_fm", "-loadmodel", str(path)], test)
    want_pred = call_bridge(jbridge, ["predict_fm", "-loadmodel", str(path)],
                            test, monkeypatch)
    assert_tsv_match(pred, want_pred, what="predict_fm")


def test_device_flag_is_taken_out_of_the_options(monkeypatch):
    train, _ = _linear_tsv(n=100, seed=4)
    base = call_bridge(tbridge, ["train_arow", "-dims", "64", "-r", "0.2",
                                 "--device", "cpu"], train, monkeypatch)
    for args in (["--device=cpu", "train_arow", "-dims", "64", "-r", "0.2"],
                 ["train_arow", "-dims", "64", "--device", "cpu", "-r",
                  "0.2"]):
        assert call_bridge(tbridge, args, train, monkeypatch) == base
    assert tbridge._pop_device(["a", "--device", "cuda:1", "b"]) == \
        (["a", "b"], "cuda:1")
    with pytest.raises(SystemExit):
        tbridge._pop_device(["train_arow", "--device"])


def test_unknown_subcommand_is_refused(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert tbridge.main(["sigmoid", "--device", "cpu"]) == 2
    assert "unknown subcommand" in capsys.readouterr().err


def test_no_device_and_no_cuda_exits_nonzero():
    """No --device means the CUDA device: without one the bridge exits
    non-zero with the RuntimeError, and emits no row."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    train, _ = _linear_tsv(n=20, seed=5)
    proc = subprocess.run(
        [os.path.join(REPO, "bin", "hivemall-tpu-torch"), "train_arow",
         "-dims", "64", "-pallas"], input=train, capture_output=True,
        text=True, timeout=300, cwd=REPO,
        env={**os.environ, "HIVEMALL_TPU_PYTHON": sys.executable})
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "device='cpu'" in proc.stderr
    assert proc.stdout == ""


def test_bin_shim_names_the_port():
    shim = os.path.join(REPO, "bin", "hivemall-tpu-torch")
    assert os.path.exists(shim) and os.access(shim, os.X_OK)
    text = open(shim).read()
    assert "-m hivemall_tpu_torch.adapters.hive_transform" in text
