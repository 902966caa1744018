"""Per-layer metrics, one module a metric, named as in BENCHMARK.json:
read(run) returns the metric's value, or None where the run has nothing
for it to read (the harness then leaves it out of the result)."""
