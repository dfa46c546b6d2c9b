"""Entry point: ``python3 port_bench/run.py --workload NAME --seed N
--seconds S --trace 0|1`` from the checkout root.  Runs one cell once and
prints the result as the last line of standard output."""

import time

#: process start, as near as Python lets it be read: set-up is timed from
#: here to the first timed request
T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout root (for ``port_bench``) and the program's sources; the
# script's own directory is dropped so that no module of the harness is
# importable under a bare top-level name
sys.path[:1] = [str(ROOT), str(ROOT / "src")]
# every build and kernel cache inside the checkout, at fixed paths, so
# only the first run of a cell in a checkout builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
# keep libraries that can load JAX from doing so
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one host thread for CPU operators: the engine's host work is a single
# thread, and an idle pool of spinning workers only adds to its noise
os.environ["OMP_NUM_THREADS"] = "1"

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], ROOT, T_START))
