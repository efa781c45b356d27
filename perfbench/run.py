"""Run one benchmark cell once and print its result line:

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. It
exits non-zero, printing no result, without them. Python's bytecode and
the kernels' caches stay in the checkout's build/ at fixed paths.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Run as a script, the harness's own directory comes first on the path,
# where its modules would shadow the standard library's (trace).
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "perfbench"]
sys.path.insert(0, str(ROOT))
# Bytecode of every module the run imports, PyTorch's too, goes to the
# checkout's build/pycache, also where the environment says not to write
# any (PYTHONDONTWRITEBYTECODE): otherwise every run compiles PyTorch's
# Python anew in its set-up.
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
