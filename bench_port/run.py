"""The port's benchmark: one run of one cell on the card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output (see bench_port/lib/harness.py); exits non-zero, printing
no result, without the card(s) the cell asks for.  The kernel and compile
caches of the run stay inside the checkout, under build/.
"""

import os
import sys
import time

T_START = time.time()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port.lib import harness  # noqa: E402

if __name__ == "__main__":
    harness.setup_env()
    sys.exit(harness.main(sys.argv[1:], T_START))
