"""Entry point: ``python -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``portbench/harness.py``)."""

import time

CLOCK0 = time.time()  # set-up is timed from here, before any import

import sys  # noqa: E402

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_cache_env()
    sys.exit(harness.main(clock0=CLOCK0))
