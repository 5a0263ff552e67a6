"""The benchmark of the PyTorch/CUDA port ``rl_mpc_lanemerging_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices.
The last line of standard output is the run's result as one JSON object;
the check's numbers, each beside its limit, are the last lines of standard
error.  ``BENCHMARK.json`` at the root names the cells; see
``benchmark/harness/main.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))   # the checkout: the program
sys.path.insert(0, _HERE)                    # harness, reference, metrics

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
