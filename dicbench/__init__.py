"""dicbench: the benchmark of correlation_tpu_torch (see README.md)."""
