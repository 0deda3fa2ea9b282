"""Run one cell of the benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``perfbench/README.md``.  Needs a CUDA card; exits with 2 without one.
"""

import time

T_START = time.perf_counter()  # set-up is timed from the process's start

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "perfbench-cache")
# every build and kernel cache at a fixed path inside the checkout (the
# program's nvcc libraries go to build/kernels/ of the checkout by itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, ROOT)

from perfbench.harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
