"""The benchmark of ``cholesky_tpu_torch`` on an NVIDIA card: one cell of
``BENCHMARK.json`` a run (``run.py``), driven by the data under this
folder."""
