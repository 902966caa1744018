"""Operators of the port: pyramid, integer sampling, the fused assembly
(CUDA kernel and plain version) and the LM step."""
