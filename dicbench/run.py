"""The benchmark's command: one run of one cell of BENCHMARK.json.

  python3 dicbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

Prints the result as one JSON object, the last line of standard output,
and each number the correctness check compared beside its limit as the
last lines of standard error.  Exits 5, printing no result, where the
cell needs more CUDA devices than there are, and 6 where the run loaded
jax, jaxlib, flax or correlation_tpu.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # Whatever a library would cache goes inside the checkout, at fixed
    # paths (the kernel library is built into ROOT/build by the program).
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    # One process with one compute thread: the solve's host path gains
    # nothing from an intra-op pool, whose threads only contend with it.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    from dicbench.harness import main

    sys.exit(main(t0=T0))
