"""Feature-engineering UDFs (numpy copies of `hivemall_tpu/ftvec/`)."""
