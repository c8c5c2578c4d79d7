"""Run one benchmark cell: ``python chipbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout."""
import time

T0 = time.perf_counter()  # set-up is timed from here

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout root, in place of this script's folder
sys.path.insert(1, str(ROOT / "src"))

from chipbench.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], root=ROOT, t0=T0))
