"""Shared set-up of the benchmark's own tests: the benchmark's modules on
the path, and a job small enough for the CPU twins."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# the cli-default job at 32 x 32, 2 spp, block 64: one image checked, 4
# patches (a tiny run of the harness on the CPU twins takes ~10 s)
TINY = {"width": 32, "height": 32, "spp": 2, "block_size": 64, "max_bounces": 1000,
        "reconstruction_radius": 2, "reconstruction_stddev": 0.5,
        "check": {"images": 1, "patches": 4}}
WORKLOAD = "cbox-spheres.cli-default"
SEED = 2**31 + 12345
