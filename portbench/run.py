"""The benchmark of the PyTorch and CUDA port, `foremast_tpu_torch`.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for. The last line of standard output is the run's result as JSON;
the numbers that decided `correct` close standard error. See README.md.
"""

import os
import sys
import time

STARTED = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

if __name__ == "__main__":
    # the checkout's root holds the harness package and the program
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    from portbench import cli

    sys.exit(cli.main(sys.argv[1:], ROOT, STARTED))
