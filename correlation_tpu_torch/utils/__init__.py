"""Host utilities of the port: checkpoints, timing and tracing."""
