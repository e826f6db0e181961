"""k-nearest-neighbour support: scalar and sparse-string distances and
similarities and minhash LSH (host Python and numpy), with the dense batch
distances, one matmul each on the device, in knn/distance.py."""

from .distance import (  # noqa: F401
    angular_distance,
    cosine_distance,
    euclid_distance,
    hamming_distance,
    jaccard_distance,
    kld,
    manhattan_distance,
    minkowski_distance,
    popcnt,
)
from .similarity import (  # noqa: F401
    angular_similarity,
    cosine_similarity,
    distance2similarity,
    euclid_similarity,
    jaccard_similarity,
)
from .lsh import bbit_minhash, minhash, minhashes  # noqa: F401
