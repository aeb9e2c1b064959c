"""The program's stages in one cell's traced sub-window, as one JSON line.

    python3 ofdm_bench/stage_report.py --workload l2k-live --seed 7

From the root of a checkout, on a machine with a CUDA device: the cell's
set-up from the seed, a window of ``--seconds`` (tracing off), then the
traced sub-window that ``run.py --trace 1`` reads, reduced by
``stages.summary``: every ``ofdm.*`` stage's host ms (median), device ms,
launches and idle ms a step, the root spans' own time, the owners of the
longest idle gaps, and the program's counters.  It is how ``PERF.md``'s
per-stage table is made; the benchmark's runs do not use it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import numpy as np

    from ofdm_bench import harness, loops, stages

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    run = harness.Run(args.workload, "cuda")
    run.prepare(args.seed)
    run.window(args.seconds, loops.Reservoir(0, np.random.default_rng(0)))
    tr = run.traced()["trace"]
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          launch_calls=tr["launch_calls"],
                          device_events=len(tr["device"]),
                          counters=stages.program_counters(),
                          **stages.summary(tr)), default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
