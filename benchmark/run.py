"""Run one cell of the port's benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (see harness.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
