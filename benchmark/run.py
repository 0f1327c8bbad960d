#!/usr/bin/env python3
"""Run one cell of the benchmark once (see harness/runner.py):

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (timg_tpu_torch).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main())
