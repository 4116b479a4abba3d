#!/usr/bin/env python3
"""Run one cell of the benchmark of cometbft_tpu_torch; see
portbench/harness.py and portbench/README.md.

    python3 portbench/run.py --workload commit10k-light --seed 1 \
        --seconds 10 --trace 0
"""
import sys
from pathlib import Path

# the checkout's root, so that `portbench` and the program import
sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
