from .batch import FeatureBlock, pack_rows, pad_to_bucket  # noqa: F401
