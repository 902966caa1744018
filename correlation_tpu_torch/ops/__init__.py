"""Operators of the port: pyramid, integer sampling and the coefficient
field, the fused assembly (CUDA kernel and plain version), the field
assembly, phase-correlation seeds and the LM step."""
