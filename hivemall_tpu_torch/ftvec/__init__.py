"""Feature-engineering function library (ref layer L4, SURVEY.md §2.9).

Host-side preprocessing utilities mirroring `hivemall.ftvec.*`, numpy copies
of `hivemall_tpu/ftvec/`; the bulk paths (feature_hashing over many rows)
hash through the native host library and feed the block packer
(core/batch.py).
"""

from ..utils.feature import (  # noqa: F401  (ref: ftvec/*.java top-level UDFs)
    add_bias,
    extract_feature,
    extract_weight,
    feature,
    feature_index,
    sort_by_feature,
)
from .amplify import amplify, rand_amplify  # noqa: F401
from .hashing import feature_hashing  # noqa: F401
from .pairing import polynomial_features, powered_features  # noqa: F401
from .scaling import l2_normalize, rescale, zscore  # noqa: F401
from .trans import (  # noqa: F401
    Quantifier,
    binarize_label,
    categorical_features,
    ffm_features,
    indexed_features,
    quantified_features,
    quantitative_features,
    vectorize_features,
)
from .conv import conv2dense, to_dense_features, to_sparse_features, quantify  # noqa: F401
from .ranking import bpr_sampling, item_pairs_sampling, populate_not_in  # noqa: F401
from .text import tf  # noqa: F401
