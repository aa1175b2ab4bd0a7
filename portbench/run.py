"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...`` from the root of the checkout).  The
last line of standard output is the run's JSON result; see
``portbench/README.md``.
"""
import time

T0 = time.perf_counter()   # set-up is timed from here, before any import

import os   # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
