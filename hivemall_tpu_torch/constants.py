"""Framework-wide constants.

Mirrors hivemall.HivemallConstants (ref: core/.../HivemallConstants.java:21-48).
"""

VERSION = "0.4.2-rc.1+torch0"

# The bias feature key. The reference appends feature "0" with value 1.0
# (ref: HivemallConstants.java:25, ftvec/AddBiasUDF.java).
BIAS_CLAUSE = "0"
BIAS_CLAUSE_INT = 0

# Default dense model dimensionality: 2^24 hashed feature space
# (ref: LearnerBaseUDTF.java:90, utils/hashing/MurmurHash3.java:27).
DEFAULT_NUM_FEATURES = 1 << 24

# JobConf keys kept for API parity (ref: HivemallConstants.java:26).
CONFKEY_RAND_AMPLIFY_SEED = "hivemall.amplify.seed"
