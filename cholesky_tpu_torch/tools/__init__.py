"""The port's tools, each run as ``python -m cholesky_tpu_torch.tools.<name>``:
``sweep`` (the benchmark and accuracy sweep that writes the golden
records), ``minibench`` (the card's probes) and ``report`` (the golden
records as the headline table)."""
