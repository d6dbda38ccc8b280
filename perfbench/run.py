"""Run one cell of the port's benchmark on the CUDA device of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the set-up's parts, then, as the last
line, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
``checks``: each number compared with its limit). Without a CUDA device,
or with fewer than the cell asks for, it exits 2 and prints no result.
The port's kernels build into ``build/kernels/`` inside the checkout on
the first run there; every other cache goes inside the checkout too.
"""
import time

T_START = time.perf_counter()

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for sub in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
    os.environ[sub] = str(ROOT / "build" / "cache" / sub.lower())
# the package by its name, and not this folder's modules as top-level ones
if Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
