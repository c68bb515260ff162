"""``python -m knnbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""

import time

_T0 = time.perf_counter()  # the process's start, for setup_s

if __name__ == "__main__":
    import sys

    from knnbench.harness import main

    sys.exit(main(t0=_T0))
