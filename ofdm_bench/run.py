"""Run one cell of the port's benchmark and print its result line.

    python3 ofdm_bench/run.py --workload g64-link --seed 7 --seconds 10 --trace 0

From the root of a checkout, on a machine with a CUDA device.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number the check compared beside its limit).  Exits
with another code than 0, and prints no result, where there is no CUDA
device, where JAX or the JAX package was loaded, or where the program is
not beside the benchmark.

Measurement options that the cells' runs do not use: ``--rate`` drives a
live cell at another rate (the sweep that fixes a cell's rate),
``--control`` puts the reference computed one precision below the
program's in the program's place (its check must fail), and several
seeds after ``--seed`` run one after another in one process, each a whole
run (set-up from its seed, window, check, the look for JAX, its result
line), which is how the check's readings on a dozen seeds are taken.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every cache the program or torch writes stays inside the checkout, at a
# fixed path, so that only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton_cache"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernel_cache"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
    os.makedirs(os.environ[var], exist_ok=True)
if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "ofdm_bench":
    sys.path[0] = str(ROOT)          # no module here shadows the stdlib's
else:
    sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, help="chunk steps a second (live)")
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from ofdm_bench import harness
    t_start = harness.process_start()
    args = parse(argv)
    spec = harness.cell_spec(args.workload)
    import torch
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    for seed in args.seed:
        run = harness.Run(args.workload, "cuda", t_start=t_start)
        m = harness.measure(run, seed, args.seconds, bool(args.trace),
                            args.rate, args.control)
        line = harness.result_line(run, m, bool(args.trace))
        bad = harness.forbidden_modules()
        if bad:
            print(f"loaded in this process: {', '.join(bad)}",
                  file=sys.stderr)
            return 3
        harness.report(run, m)
        print(json.dumps(line), flush=True)
        # the next seed's set-up starts now, with nothing of this one kept
        del run, m
        gc.unfreeze()
        gc.collect()
        t_start = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
