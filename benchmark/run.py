"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port. See
``benchmark/README.md``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")
sys.path[:0] = [str(HERE), str(ROOT)]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
