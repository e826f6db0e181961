"""The port's SQL-name registry (hivemall_tpu_torch/sql/registry.py) against
the JAX package's: every define-all.hive name and macro resolves to a port
callable, the two name sets are equal, and each host function gives the
JAX package's output on the same arguments — exactly for ints and strings,
at rtol 1e-6 for floats."""

import itertools
import random
import types

import numpy as np
import pytest

from hivemall_tpu import sql as jsql
from hivemall_tpu_torch import sql as tsql

# the reference's resources/ddl/define-all.hive names, as
# tests/test_sql_registry.py lists them
from test_sql_registry import DEFINE_ALL_NAMES, MACRO_NAMES


@pytest.mark.parametrize("name", DEFINE_ALL_NAMES + MACRO_NAMES)
def test_name_resolves_to_a_port_callable(name):
    fn = tsql.get_function(name)
    assert callable(fn)
    assert fn.__module__.split(".")[0] == "hivemall_tpu_torch", fn.__module__


def test_list_functions_equals_the_jax_packages():
    assert set(tsql.list_functions()) == set(jsql.list_functions())
    assert len(tsql.list_functions()) == len(jsql.list_functions())
    assert set(tsql.macros()) == set(jsql.macros())
    assert set(tsql.REGISTRY) == set(jsql.REGISTRY)


def test_unknown_name_raises():
    with pytest.raises(KeyError):
        tsql.get_function("nope")


def test_hivemall_version_is_the_ports():
    from hivemall_tpu_torch import version
    from hivemall_tpu_torch.constants import VERSION

    assert tsql.get_function("hivemall_version")() == VERSION == version()
    assert "torch" in VERSION


FV_A = ["1:1.0", "2:0.5", "7:2.0"]
FV_B = ["1:0.5", "3:1.0", "7:1.0"]
TEXT = "The quick brown fox, isn't it: Über café ５０％"

# name -> a function of the package's root module giving the arguments;
# one case per host function of the registry
HOST_CASES = {
    "add_bias": lambda m: (FV_A,),
    "add_feature_index": lambda m: ([0.5, 2.0, 3.25],),
    "amplify": lambda m: (3, [1, 2, 3]),
    "angular_distance": lambda m: (FV_A, FV_B),
    "angular_similarity": lambda m: (FV_A, FV_B),
    "argmin_kld": lambda m: ([(1.0, 1.0), (3.0, 0.5), (None, 1.0)],),
    "array_avg": lambda m: ([[1.0, 2.0], [3.0, 5.0]],),
    "array_concat": lambda m: ([1, 2], [3], [4, 5]),
    "array_hash_values": lambda m: (["a", "bb", "ccc"],),
    "array_intersect": lambda m: ([1, 2, 3, 4], [2, 4, 6], [4, 2]),
    "array_remove": lambda m: ([1, 2, 1, 3], 1),
    "array_sum": lambda m: ([[1.0, 2.0], [3.0, 5.0]],),
    "base91": lambda m: ("hello world",),
    "bbit_minhash": lambda m: (["a", "b", "c"], 64, 1),
    "binarize_label": lambda m: (2, 1, "f1", "f2"),
    "bits_collect": lambda m: ([1, 5, 64, 130],),
    "bits_or": lambda m: ([1, 2], [4], [8, 16]),
    "bpr_sampling": lambda m: ({1: [2, 3], 2: [1]}, 6, 1.0, True, 7),
    "bprmf_predict": lambda m: ([1.0, 0.5], [0.5, 2.0], 0.25),
    "categorical_features": lambda m: (["a", "b"], "x", 3),
    "collect_all": lambda m: ([3, 1, 3, 2],),
    "concat_array": lambda m: ([1], [2, 3]),
    "conv2dense": lambda m: ([(1, 0.5), (3, 2.0)], 5),
    "convert_label": lambda m: (-1.0,),
    "cosine_distance": lambda m: (FV_A, FV_B),
    "cosine_similarity": lambda m: (FV_A, FV_B),
    "deflate": lambda m: ("aaaaabbbbbaaaaa",),
    "distance2similarity": lambda m: (3.0,),
    "each_top_k": lambda m: (2, [("g1", 0.5, [1]), ("g1", 0.9, [2]),
                                 ("g1", 0.1, [3]), ("g2", 0.3, [4])]),
    "euclid_distance": lambda m: (FV_A, FV_B),
    "euclid_similarity": lambda m: (FV_A, FV_B),
    "extract_feature": lambda m: ("height:1.8",),
    "extract_weight": lambda m: ("height:1.8",),
    "f1score": lambda m: ([[1, 2], [3]], [[2], [3, 4]]),
    "feature": lambda m: ("a", 2.5),
    "feature_hashing": lambda m: (["apple:1.5", "7:2", "banana"],),
    "feature_index": lambda m: ("12:0.5",),
    "ffm_features": lambda m: (["a", "b"], "x", 2.5),
    "float_array": lambda m: (4, 0.5),
    "fm_predict": lambda m: (0.1, [0.5, -0.2], [[0.1, 0.2], [0.3, -0.4]],
                             [0, 2], [1.0, 2.0]),
    "generate_series": lambda m: (3, 7),
    "guess_attribute_types": lambda m: ([1.5, "a", 3, True],),
    "hamming_distance": lambda m: (0b1011, 0b0110),
    "indexed_features": lambda m: (1.5, 2.0, 0.0),
    "inflate": lambda m: (m.tools.deflate("some text to squash"),),
    "is_stopword": lambda m: ("The",),
    "item_pairs_sampling": lambda m: ([1, 3, 4], 6, 1.0, 11),
    "jaccard_distance": lambda m: ([1, 2, 3], [2, 3, 4]),
    "jaccard_similarity": lambda m: (FV_A, FV_B),
    "jobconf_gets": lambda m: ("hivemall.amplify.seed", "none"),
    "kld": lambda m: (0.1, 1.0, 0.3, 2.0),
    "l2_normalize": lambda m: (FV_A,),
    "logloss": lambda m: ([0.9, 0.2, 0.6], [1.0, 0.0, 1.0]),
    "lr_datagen": lambda m: ("-n_examples 20 -n_features 4 -n_dims 30 "
                             "-seed 5 -cl",),
    "mae": lambda m: ([1.0, 2.0, 4.0], [1.5, 2.0, 3.0]),
    "manhattan_distance": lambda m: (FV_A, FV_B),
    "map_get_sum": lambda m: ({1: 0.5, 2: 1.5, 3: 2.0}, [1, 3, 9]),
    "map_tail_n": lambda m: ({3: "c", 1: "a", 2: "b"}, 2),
    "max_label": lambda m: ([(0.5, "a"), (0.9, "b"), (0.1, "c")],),
    "maxrow": lambda m: ([(0.5, "a"), (0.9, "b"), (0.1, "c")],),
    "mf_predict": lambda m: ([1.0, 2.0], [0.5, 0.25], 0.1, 0.2, 3.0),
    "mhash": lambda m: ("hello",),
    "minhash": lambda m: ("item7", FV_A, 4, 2),
    "minhashes": lambda m: (FV_A, 4, 2),
    "minkowski_distance": lambda m: (FV_A, FV_B, 3.0),
    "mse": lambda m: ([1.0, 2.0, 4.0], [1.5, 2.0, 3.0]),
    "ndcg": lambda m: ([3, 1, 2, 5], [1, 5], 3),
    "normalize_unicode": lambda m: (TEXT,),
    "polynomial_features": lambda m: (FV_A, 2),
    "popcnt": lambda m: (0b101101,),
    "populate_not_in": lambda m: ([1, 3], 5),
    "powered_features": lambda m: (FV_A, 3),
    "prefixed_hash_values": lambda m: (["a", "b"], "p:", 1 << 20),
    "quantified_features": lambda m: (m.ftvec.Quantifier(), "x", 1.5, "y",
                                      "x"),
    "quantify": lambda m: (None, "x", 1.5, "y", "x"),
    "quantitative_features": lambda m: (["a", "b"], 1.5, 0.0),
    "r2": lambda m: ([1.0, 2.0, 4.0], [1.5, 2.0, 3.0]),
    "rand_amplify": lambda m: (2, 3, [1, 2, 3, 4, 5], 9),
    "rescale": lambda m: (3.0, 1.0, 9.0),
    "rf_ensemble": lambda m: ([1, 0, 1, 2, 1],),
    "rmse": lambda m: ([1.0, 2.0, 4.0], [1.5, 2.0, 3.0]),
    "sha1": lambda m: ("hello",),
    "sigmoid": lambda m: (0.3,),
    "sort_and_uniq_array": lambda m: ([3, 1, 3, 2],),
    "sort_by_feature": lambda m: (["9:1", "2:1", "10:1"],),
    "split_words": lambda m: ("a b  c\td",),
    "subarray": lambda m: ([1, 2, 3, 4, 5], 1, 3),
    "subarray_endwith": lambda m: ([1, 2, 3, 4, 5], 3),
    "subarray_startwith": lambda m: ([1, 2, 3, 4, 5], 3),
    "tf": lambda m: (["a", "b", "a", "c"],),
    "to_bits": lambda m: ([1, 5, 64],),
    "to_dense": lambda m: (FV_A, 8),
    "to_dense_features": lambda m: (FV_A, 8),
    "to_map": lambda m: ([(1, "a"), (2, "b")],),
    "to_ordered_map": lambda m: ([(2, "b"), (1, "a")], True),
    "to_sparse": lambda m: ([0.0, 1.5, 0.0, 2.0],),
    "to_sparse_features": lambda m: ([0.0, 1.5, 0.0, 2.0],),
    "to_string_array": lambda m: ([1, 2.5, "x"],),
    "tokenize": lambda m: (TEXT, True),
    "tokenize_ja": lambda m: ("関西国際空港に行きました", "search"),
    "tree_predict": lambda m: ("json", '{"leaf": false, "feature": 0, '
                               '"threshold": 0.5, "left": {"leaf": true, '
                               '"value": 1.0}, "right": {"leaf": true, '
                               '"value": 2.0}}', [0.7]),
    "unbase91": lambda m: (m.tools.base91("hello world"), True),
    "unbits": lambda m: ([0b100010, 1],),
    "vectorize_features": lambda m: (["a", "b"], 1.5, "x"),
    "voted_avg": lambda m: ([-1.0, 2.0, 3.0],),
    "weight_voted_avg": lambda m: ([-5.0, 2.0, 3.0],),
    "x_rank": lambda m: (["a", "a", "b", "a"],),
    "zscore": lambda m: (3.0, 1.0, 2.0),
    # macros
    "java_min": lambda m: (3, 2),
    "max2": lambda m: (3, 7),
    "min2": lambda m: (3, 7),
    "idf": lambda m: (3.0, 100.0),
    "tfidf": lambda m: (0.5, 3.0, 100.0),
    "rand_gid2": lambda m: (10, 42),
}
# draw from Python's random module: both packages are called with it seeded
# alike
SEEDED = {"rand_gid": lambda m: (1000,)}


def _plain(x):
    """A comparable form: generators, tuples, arrays and dicts opened up."""
    if isinstance(x, types.GeneratorType) or isinstance(x, itertools.chain):
        x = list(x)
    if isinstance(x, np.ndarray):
        x = x.tolist()
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__iter__") and not isinstance(x, (str, bytes)):
        return [_plain(v) for v in x]
    return x


def assert_same(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (where, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _roots():
    import hivemall_tpu
    import hivemall_tpu.ftvec
    import hivemall_tpu.tools
    import hivemall_tpu_torch
    import hivemall_tpu_torch.ftvec
    import hivemall_tpu_torch.tools

    return hivemall_tpu, hivemall_tpu_torch


@pytest.mark.parametrize("name", sorted(HOST_CASES) + sorted(SEEDED))
def test_host_function_equals_jax(name, monkeypatch):
    monkeypatch.setenv("HIVEMALL_AMPLIFY_SEED", "77")
    jroot, troot = _roots()
    args_of = HOST_CASES.get(name) or SEEDED[name]
    out = []
    for reg, root in ((tsql, troot), (jsql, jroot)):
        random.seed(1234)
        out.append(_plain(reg.get_function(name)(*args_of(root))))
    assert_same(out[0], out[1], name)


def test_every_host_function_has_a_case():
    trainers = {n for n in tsql.list_functions()
                if n.startswith("train_") or n == "logress"}
    # scored over a trained model object; the SQLite and bridge tests
    # cover it
    model_scorers = {"ffm_predict"}
    # the task context, held in test_task_context_matches
    context = {"taskid", "jobid", "rowid", "distcache_gets",
               "hivemall_version"}
    left = (set(tsql.list_functions()) - trainers - model_scorers - context
            - set(HOST_CASES) - set(SEEDED))
    assert not left, sorted(left)


def test_task_context_matches(tmp_path, monkeypatch):
    """taskid is 0 with no process group; jobid takes HIVEMALL_TPU_JOB_ID;
    rowid is "taskid-seq"; distcache_gets reads the same file."""
    from hivemall_tpu.tools import mapred as jm
    from hivemall_tpu_torch.tools import mapred as tm

    monkeypatch.setenv("HIVEMALL_TPU_JOB_ID", "job_fixed")
    path = tmp_path / "cache.tsv"
    path.write_text("k1\tv1\nk2\tv2\n")
    out = []
    for mod in (tm, jm):
        monkeypatch.setattr(mod, "_JOB_ID", None)
        monkeypatch.setattr(mod, "_ROW_COUNTER", itertools.count())
        out.append((mod.taskid(), mod.jobid(), [mod.rowid() for _ in range(3)],
                    mod.distcache_gets(str(path), "k2"),
                    mod.distcache_gets(str(path), "zz", "dflt")))
    assert out[0] == out[1] == (0, "job_fixed", ["0-0", "0-1", "0-2"], "v2",
                                "dflt")


def test_taskid_is_the_rank_of_the_process_group(tmp_path):
    import torch.distributed as dist

    from hivemall_tpu_torch.tools import taskid

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        assert taskid() == dist.get_rank() == 0
    finally:
        dist.destroy_process_group()
