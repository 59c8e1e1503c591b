"""The metrics, one reader each, found by the metric's name in
BENCHMARK.json: ``read(run)`` returns the value, or None where the run
holds nothing to read (the metric is then left out of the line). A reader
may define ``Probe``, a context manager active over a traced run's window
with ``before_call()`` and ``after_call()`` around each call."""
