"""Host-side tool UDFs (numpy copies of `hivemall_tpu/tools/`)."""
