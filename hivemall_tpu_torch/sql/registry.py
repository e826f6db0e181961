"""The SQL-name function registry — L5 parity surface.

Mirrors `resources/ddl/define-all.hive` (607 lines, ~150 CREATE TEMPORARY
FUNCTION statements): every SQL name the reference registers resolves here to
the equivalent Python callable, so a Hivemall user can look up any function
they know by its SQL name (`get_function("train_arow")`). Aliases (to_dense /
to_dense_features, logress / train_logistic_regr, concat_array / array_concat,
train_randomforest_regressor / _regr) are kept.

The reference's SQL *macros* (define-all.hive:582-607) are plain functions
here: max2, min2, idf, tfidf, rand_gid, rand_gid2.

The port's copy of `hivemall_tpu/sql/registry.py`: the same names, aliases
and macros, resolving to the port's callables. The trainers take
``device=`` (None is the CUDA device; see device.resolve_device).
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, List

from .. import version as _version
from ..dataset import lr_datagen
from ..ensemble import (argmin_kld, max_label, maxrow, rf_ensemble, voted_avg,
                        weight_voted_avg)
from ..evaluation import f1score, logloss, mae, mse, ndcg, r2, rmse
from ..ftvec import (add_bias, amplify, binarize_label, bpr_sampling,
                     categorical_features, conv2dense, extract_feature,
                     extract_weight, feature, feature_hashing, feature_index,
                     ffm_features, indexed_features, item_pairs_sampling,
                     l2_normalize, polynomial_features, populate_not_in,
                     powered_features, quantified_features, quantify,
                     quantitative_features, rand_amplify, rescale,
                     sort_by_feature, tf, to_dense_features,
                     to_sparse_features, vectorize_features, zscore)
from ..knn import (angular_distance, angular_similarity, bbit_minhash,
                   cosine_distance, cosine_similarity, distance2similarity,
                   euclid_distance, euclid_similarity, hamming_distance,
                   jaccard_distance, jaccard_similarity, kld,
                   manhattan_distance, minhash, minhashes, minkowski_distance,
                   popcnt)
from ..models import classifier as _cls
from ..models import multiclass as _mc
from ..models import regression as _regr
from ..models.ffm import ffm_predict, train_ffm
from ..models.fm import fm_predict, train_fm
from ..models.mf import (bprmf_predict, mf_predict, train_bprmf,
                         train_mf_adagrad, train_mf_sgd)
from ..nlp import tokenize_ja
from ..models.trees import (guess_attrs, train_gradient_tree_boosting_classifier,
                            train_randomforest_classifier,
                            train_randomforest_regr, tree_predict)
from ..tools import (array_avg, array_concat, array_intersect, array_remove,
                     array_sum, base91, bits_collect, bits_or, collect_all,
                     convert_label, deflate, distcache_gets, each_top_k,
                     float_array, generate_series, inflate, is_stopword,
                     jobconf_gets, jobid, map_get_sum, map_tail_n,
                     normalize_unicode, rowid, sigmoid, sort_and_uniq_array,
                     split_words, subarray, subarray_endwith,
                     subarray_startwith, taskid, to_bits, to_map,
                     to_ordered_map, to_string_array, tokenize, unbase91,
                     unbits, x_rank)
from ..utils.hashing import array_hash_values, mhash, sha1_hash


def _add_feature_index(features):
    """`add_feature_index(array<double>)` -> ["1:v1", ...]
    (ref: ftvec/AddFeatureIndexUDF.java)."""
    return [f"{i + 1}:{float(v)}" for i, v in enumerate(features)]


def prefixed_hash_values(values, prefix, num_features=None):
    from ..utils.hashing import DEFAULT_NUM_FEATURES
    from ..utils.hashing import array_hash_values as ahv

    return ahv(values, prefix, num_features or DEFAULT_NUM_FEATURES)


# ---- macros (ref: define-all.hive:582-607) ----

def max2(x, y):
    return x if x > y else y


def min2(x, y):
    return x if x < y else y


def java_min(x, y):
    return min(x, y)


def rand_gid(k: int) -> int:
    return int(random.random() * k)


def rand_gid2(k: int, seed: int) -> int:
    return int(random.Random(seed).random() * k)


def idf(df_t: float, n_docs: float) -> float:
    return math.log10(n_docs / max2(1.0, df_t)) + 1.0


def tfidf(tf_value: float, df_t: float, n_docs: float) -> float:
    return tf_value * idf(df_t, n_docs)


REGISTRY: Dict[str, Callable] = {
    "hivemall_version": _version,
    # binary classifiers (§2.3)
    "train_perceptron": _cls.train_perceptron,
    "train_pa": _cls.train_pa,
    "train_pa1": _cls.train_pa1,
    "train_pa2": _cls.train_pa2,
    "train_cw": _cls.train_cw,
    "train_arow": _cls.train_arow,
    "train_arowh": _cls.train_arowh,
    "train_scw": _cls.train_scw,
    "train_scw2": _cls.train_scw2,
    "train_adagrad_rda": _cls.train_adagrad_rda,
    # multiclass (§2.4)
    "train_multiclass_perceptron": _mc.train_multiclass_perceptron,
    "train_multiclass_pa": _mc.train_multiclass_pa,
    "train_multiclass_pa1": _mc.train_multiclass_pa1,
    "train_multiclass_pa2": _mc.train_multiclass_pa2,
    "train_multiclass_cw": _mc.train_multiclass_cw,
    "train_multiclass_arow": _mc.train_multiclass_arow,
    "train_multiclass_arowh": _mc.train_multiclass_arowh,
    "train_multiclass_scw": _mc.train_multiclass_scw,
    "train_multiclass_scw2": _mc.train_multiclass_scw2,
    # similarity / distance / LSH (§2.10)
    "cosine_similarity": cosine_similarity,
    "jaccard_similarity": jaccard_similarity,
    "angular_similarity": angular_similarity,
    "euclid_similarity": euclid_similarity,
    "distance2similarity": distance2similarity,
    "popcnt": popcnt,
    "kld": kld,
    "hamming_distance": hamming_distance,
    "euclid_distance": euclid_distance,
    "cosine_distance": cosine_distance,
    "angular_distance": angular_distance,
    "jaccard_distance": jaccard_distance,
    "manhattan_distance": manhattan_distance,
    "minkowski_distance": minkowski_distance,
    "minhashes": minhashes,
    "minhash": minhash,
    "bbit_minhash": bbit_minhash,
    # ensemble (§2.12)
    "voted_avg": voted_avg,
    "weight_voted_avg": weight_voted_avg,
    "max_label": max_label,
    "maxrow": maxrow,
    "argmin_kld": argmin_kld,
    "rf_ensemble": rf_ensemble,
    # hashing (§2.9)
    "mhash": mhash,
    "sha1": sha1_hash,
    "array_hash_values": array_hash_values,
    "prefixed_hash_values": prefixed_hash_values,
    "feature_hashing": feature_hashing,
    # pairing / scaling
    "polynomial_features": polynomial_features,
    "powered_features": powered_features,
    "rescale": rescale,
    "zscore": zscore,
    "l2_normalize": l2_normalize,
    # amplify
    "amplify": amplify,
    "rand_amplify": rand_amplify,
    # ftvec top-level
    "add_bias": add_bias,
    "sort_by_feature": sort_by_feature,
    "extract_feature": extract_feature,
    "extract_weight": extract_weight,
    "add_feature_index": _add_feature_index,
    "feature": feature,
    "feature_index": feature_index,
    # conv
    "conv2dense": conv2dense,
    "to_dense_features": to_dense_features,
    "to_dense": to_dense_features,
    "to_sparse_features": to_sparse_features,
    "to_sparse": to_sparse_features,
    "quantify": quantify,
    # trans
    "vectorize_features": vectorize_features,
    "categorical_features": categorical_features,
    "ffm_features": ffm_features,
    "indexed_features": indexed_features,
    "quantified_features": quantified_features,
    "quantitative_features": quantitative_features,
    "binarize_label": binarize_label,
    # ranking
    "bpr_sampling": bpr_sampling,
    "item_pairs_sampling": item_pairs_sampling,
    "populate_not_in": populate_not_in,
    # text ftvec
    "tf": tf,
    # regression (§2.5)
    "logress": _regr.train_logistic_regr,
    "train_logistic_regr": _regr.train_logistic_regr,
    "train_pa1_regr": _regr.train_pa1_regr,
    "train_pa1a_regr": _regr.train_pa1a_regr,
    "train_pa2_regr": _regr.train_pa2_regr,
    "train_pa2a_regr": _regr.train_pa2a_regr,
    "train_arow_regr": _regr.train_arow_regr,
    "train_arowe_regr": _regr.train_arowe_regr,
    "train_arowe2_regr": _regr.train_arowe2_regr,
    "train_adagrad_regr": _regr.train_adagrad_regr,
    "train_adadelta_regr": _regr.train_adadelta_regr,
    # tools: array
    "float_array": float_array,
    "array_remove": array_remove,
    "sort_and_uniq_array": sort_and_uniq_array,
    "subarray_endwith": subarray_endwith,
    "subarray_startwith": subarray_startwith,
    "array_concat": array_concat,
    "concat_array": array_concat,
    "subarray": subarray,
    "array_avg": array_avg,
    "array_sum": array_sum,
    "to_string_array": to_string_array,
    "array_intersect": array_intersect,
    "collect_all": collect_all,
    # tools: bits
    "bits_collect": bits_collect,
    "to_bits": to_bits,
    "unbits": unbits,
    "bits_or": bits_or,
    # tools: compress
    "inflate": inflate,
    "deflate": deflate,
    # tools: map
    "map_get_sum": map_get_sum,
    "map_tail_n": map_tail_n,
    "to_map": to_map,
    "to_ordered_map": to_ordered_map,
    # tools: math / mapred / misc / text
    "sigmoid": sigmoid,
    "taskid": taskid,
    "jobid": jobid,
    "rowid": rowid,
    "distcache_gets": distcache_gets,
    "jobconf_gets": jobconf_gets,
    "generate_series": generate_series,
    "convert_label": convert_label,
    "x_rank": x_rank,
    "each_top_k": each_top_k,
    "tokenize": tokenize,
    "is_stopword": is_stopword,
    "split_words": split_words,
    "normalize_unicode": normalize_unicode,
    "base91": base91,
    "unbase91": unbase91,
    # dataset
    "lr_datagen": lr_datagen,
    # evaluation (§2.11)
    "f1score": f1score,
    "mae": mae,
    "mse": mse,
    "rmse": rmse,
    "r2": r2,
    "ndcg": ndcg,
    "logloss": logloss,
    # MF (§2.7)
    "mf_predict": mf_predict,
    "train_mf_sgd": train_mf_sgd,
    "train_mf_adagrad": train_mf_adagrad,
    "train_bprmf": train_bprmf,
    "bprmf_predict": bprmf_predict,
    # FM / FFM (§2.6)
    "fm_predict": fm_predict,
    "train_fm": train_fm,
    "train_ffm": train_ffm,
    "ffm_predict": ffm_predict,
    # nlp (ref: resources/ddl/define-additional.hive:9-10)
    "tokenize_ja": tokenize_ja,
    # trees (§2.8)
    "train_randomforest_classifier": train_randomforest_classifier,
    "train_randomforest_regressor": train_randomforest_regr,
    "train_randomforest_regr": train_randomforest_regr,
    "train_gradient_tree_boosting_classifier": train_gradient_tree_boosting_classifier,
    "tree_predict": tree_predict,
    "guess_attribute_types": guess_attrs,
}

MACROS: Dict[str, Callable] = {
    "java_min": java_min,
    "max2": max2,
    "min2": min2,
    "rand_gid": rand_gid,
    "rand_gid2": rand_gid2,
    "idf": idf,
    "tfidf": tfidf,
}


def get_function(name: str) -> Callable:
    fn = REGISTRY.get(name) or MACROS.get(name)
    if fn is None:
        raise KeyError(f"unknown function {name!r}; see list_functions()")
    return fn


def list_functions() -> List[str]:
    return sorted(REGISTRY) + sorted(MACROS)


def macros() -> Dict[str, Callable]:
    return dict(MACROS)
