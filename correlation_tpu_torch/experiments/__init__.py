"""Ports of the JAX package's kernel experiments (experiments/exp_*.py).

Each module holds a hand-written CUDA kernel's wrapper, its plain PyTorch
version and a command-line entry point that times both on the card:

  python -m correlation_tpu_torch.experiments.exp_gather
  python -m correlation_tpu_torch.experiments.exp_matmul_overhead [loop batched gram vpu]

and the port of experiments/profile_bench.py, the dense-grid solve's time
split by phase on the card:

  python -m correlation_tpu_torch.experiments.profile_bench
"""
