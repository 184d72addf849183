"""The benchmark's command: one run of one cell on the card.

    python3 benchmark/run.py --workload anno20.batch --seed 7 --seconds 51 --trace 0

from the root of a checkout.  See :mod:`benchmark.harness`.
"""

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host sets the pace of every pass, and
# idle worker threads of the CPU's thread pools only compete with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root holds the program and the benchmark package; the
# benchmark's own directory is not a root of imports
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], PROCESS_START))
