"""Host utilities of the port: checkpoints and timing."""
