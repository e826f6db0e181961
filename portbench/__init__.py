"""The benchmark of `hivemall_tpu_torch`, the PyTorch and CUDA port.

One run trains whole fits of one cell back to back for a fixed number of
seconds and prints one JSON line (see `run.py`). Everything that belongs to
one configuration, one cell or one per-layer metric is a file of its own,
found by the name `BENCHMARK.json` gives it:

- `configs/<config>.json`: a deployment (trainer, options, model size, the
  law its rows follow), named by `BENCHMARK.json`'s `configs[].file`;
- `cells/<workload>.json`: a cell's traffic (the fit's options, epochs, the
  rows it warms up on, the end-to-end rate it reports, its check limits);
- `metrics/<metric>.py`: a per-layer metric's reader (`read(view)`);
- `reference/<rule>.py`: a learner's closed form for the plain reference.

The yardstick lives here too: the row generator (`traffic.py`), the count
functions (`counts/`), the table of peaks (`peaks.json`), the trace reduction
(`trace.py`) and the plain reference with the comparison that decides
`correct` (`reference/`, `check.py`). Nothing under this package imports JAX
or the JAX package, and nothing but `harness.py` and `faults.py` imports
the port.
"""
