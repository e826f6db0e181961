"""Synthetic data generators (numpy copies of `hivemall_tpu/dataset/`)."""

from .lr_datagen import DriftStream, lr_datagen  # noqa: F401
