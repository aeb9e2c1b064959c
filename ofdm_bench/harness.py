"""The benchmark of ``lte_gnu_radio_code_tpu_torch``: one run of one cell.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``; the mix names the program's entry it drives,
``entries/<entry>.py``, and its parameters; ``cells/<cell>.json`` holds the
check's sample sizes and limits; each per-layer metric is read by
``metrics/<name>.py``, or by ``metrics/<stem>.py`` for a name
``<stem>.<suffix>``.  A new cell, configuration, mix or metric is a new
file or entry; nothing here changes.

A run: set-up (import, the CUDA context, the kernels' library, the
entry's tables and objects, its inputs from the seed, one pass of every
shape the window uses), the window of ``seconds``, with ``trace`` a
profiled sub-window and the host's enqueue times after it, then the check
of a seeded sample of the window's answers against the plain reference
(``reference/``).  The last line of standard output is the result.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np

from . import devtrace, judge, loops

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lte_gnu_radio_code_tpu")
PROFILE_STEPS = 40
SETTLE_S = 2.0
HOST_STEPS = 20


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    """The cell's workload entry, its configuration, mix, check and the
    metrics it reports, from ``BENCHMARK.json`` and the files it names."""
    spec = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: one of "
                         f"{sorted(cells)}")
    w = cells[name]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(
        workload=w, config=read_json(BENCH / "configs" / f"{w['config']}.json"),
        traffic=read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        check=read_json(BENCH / "cells" / f"{name}.json"),
        end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]))


def metric_module(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, else
    ``metrics/<stem>.py``; its ``read(ctx)`` returns the reading or None."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"ofdm_bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{BENCH / 'metrics'}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def process_start() -> float:
    """The process's start on ``time.time``'s clock (Linux ``/proc``),
    else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def host_counters(before: dict | None = None) -> dict:
    """What a run can see of its host's speed (Linux): the machine's CPU
    steal time and this process's CPU seconds and involuntary context
    switches; with ``before``, the change since then."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    now = {"cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            now["steal_s"] = int(f.readline().split()[8]) / os.sysconf(
                "SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    if before is None:
        return now
    return {k: v - before.get(k, 0) for k, v in now.items()}


class Run:
    """Set-up of one cell: the entry built and warmed on ``device``."""

    def __init__(self, cell: str, device: str = "cuda",
                 overrides: dict | None = None, t_start: float | None = None):
        self.t_start = time.time() if t_start is None else t_start
        self.spec = cell_spec(cell)
        self.cell = cell
        self.traffic = dict(self.spec["traffic"], **(overrides or {}))
        import torch
        mod = importlib.import_module(f"ofdm_bench.entries."
                                      f"{self.traffic['entry']}")
        from lte_gnu_radio_code_tpu_torch.kernels import _cuda
        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.parts = {"import": time.time() - self.t_start}   # from the start
        t = time.perf_counter()
        if self.cuda:
            torch.cuda.init()
            torch.zeros(1, device=self.device)
            t = self._part("context", t)
            _cuda.library()
            t = self._part("kernels", t)
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.clock = loops.DeviceClock(torch) if self.cuda else \
            loops.HostClock()
        self.entry = mod.Entry(self.spec["config"], self.traffic,
                               self.device)
        self._part("tables", t)

    def _part(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - t
        return now

    def sync(self) -> None:
        self.clock.sync()

    def prepare(self, seed: int) -> None:
        """The inputs from the seed, then one pass of every shape."""
        t = time.perf_counter()
        self.entry.make_inputs(seed)
        self.sync()
        t = self._part("inputs", t)
        self.next_i = 0
        for _ in range(self.entry.warm_steps()):
            self.entry.step(self.next_i)
            self.next_i += 1
        self.sync()
        # the window's own loop for SETTLE_S, so that the window starts with
        # the host's caches and the card's clocks where they stay
        self.window(SETTLE_S, loops.Reservoir(0, np.random.default_rng(0)))
        # what set-up made stays: a full collection now, and none that
        # walks it again inside the window
        gc.collect()
        gc.freeze()
        self._part("warm_up", t)

    def window(self, seconds: float, keep: loops.Reservoir,
               rate: float | None = None, span=None) -> dict:
        """The measured window; returns its end-to-end readings."""
        e = self.entry
        before = host_counters()
        if e.loop == "closed":
            n, wall, marks = loops.closed_loop(e.step, self.next_i, seconds,
                                               self.clock, keep, span)
            self.next_i += n
            per_s = np.bincount(marks.astype(int))[:int(seconds)]
            return dict(steps=n, wall_s=wall,
                        link_msamples_s=n * e.samples_per_step / wall / 1e6,
                        steps_by_second=per_s.tolist(),
                        host=host_counters(before))
        rate = rate or e.rate_hz
        n = int(round(seconds * rate))
        due, started, done = loops.open_loop(e.step, self.next_i, n, rate,
                                             self.clock, keep, span)
        self.next_i += n
        lat_ms = (done - due) * 1e3
        tenth = max(1, n // 10)
        return dict(steps=n, wall_s=float(done[-1] - due[0]),
                    host=host_counters(before),
                    live_p50_ms=loops.percentile(lat_ms, 50),
                    live_p95_ms=loops.percentile(lat_ms, 95),
                    backlog_max=loops.backlog_max(due, done),
                    latency_max_ms=float(lat_ms.max()),
                    latency_first_tenth_ms=float(lat_ms[:tenth].mean()),
                    latency_last_tenth_ms=float(lat_ms[-tenth:].mean()),
                    host_late_p95_ms=loops.percentile(
                        (started - due) * 1e3, 95), rate_hz=rate)

    def traced(self, rate: float | None = None) -> dict:
        """A profiled sub-window of ``PROFILE_STEPS`` steps in the
        window's own loop, then the host's time to enqueue each of
        ``HOST_STEPS`` steps on an idle device."""
        torch = self.torch
        from torch.profiler import record_function

        def run():
            keep = loops.Reservoir(0, np.random.default_rng(0))
            if self.entry.loop == "closed":
                for _ in range(PROFILE_STEPS):
                    with record_function("harness.step"):
                        self.entry.step(self.next_i)
                    self.next_i += 1
            else:
                r = rate or self.entry.rate_hz
                self.window(PROFILE_STEPS / r, keep, r, record_function)
            return PROFILE_STEPS

        tr = devtrace.capture(run, torch)
        host_ms = []
        for _ in range(HOST_STEPS):
            self.sync()
            t = time.perf_counter()
            self.entry.step(self.next_i)
            host_ms.append((time.perf_counter() - t) * 1e3)
            self.next_i += 1
        self.sync()
        return dict(trace=tr, host_ms=host_ms, k4=self.entry.k4_shape())

    def check(self, keep: loops.Reservoir, seed: int, control: bool = False
              ) -> judge.Tally:
        """The sampled answers of the window against the reference: each
        kept step's ``check_answers`` answers (frames or streams), dealt in
        turn from one permutation drawn from the seed, so that the kept
        steps together cover every index they can; with ``control`` the
        control's answers in the program's place."""
        ck = self.spec["check"]
        tally = judge.Tally(ck["limits"])
        rng = np.random.default_rng([seed, 2])
        limits = dict(ck["limits"], tie_share_of_gate=ck["tie_share_of_gate"])
        order = rng.permutation(self.entry.answers_per_step)
        count = min(ck["check_answers"], len(order))
        kept = sorted(keep.items, key=lambda kv: kv[0])
        for j, (i, out) in enumerate(kept):
            picks = np.sort(order.take(np.arange(j * count, (j + 1) * count),
                                       mode="wrap"))
            for key, got in self.entry.answers(i, out, picks):
                if control:
                    got = self.entry.control(key)
                r = self.entry.judge(key, got, limits)
                tally.followed += r.pop("followed")
                tally.add(r)
        return tally


def measure(run: Run, seed: int, seconds: float, trace: bool,
            rate: float | None = None, control: bool = False) -> dict:
    """One seed's window (and traced sub-window) and its check, on a
    prepared run; the result's fields."""
    ck = run.spec["check"]
    run.prepare(seed)
    setup_s = time.time() - run.t_start
    keep = loops.Reservoir(ck["check_steps"], np.random.default_rng([seed, 1]),
                           run.entry.strata)
    win = run.window(seconds, keep, rate)
    peak = run.torch.cuda.max_memory_allocated(run.device) if run.cuda else 0
    per_layer = {}
    extra = {}
    if trace:
        ctx = run.traced(rate)
        ctx.update(window=win, loop=run.entry.loop)
        for m in run.spec["per_layer"]:
            v = metric_module(m["name"]).read(ctx)
            if v is not None:
                per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = ctx["trace"]
        extra = dict(busy_s=devtrace.busy_s(tr["device"]),
                     window_s=tr["window_s"],
                     breakdown=devtrace.breakdown(tr),
                     launch_calls=tr["launch_calls"] / tr["steps"])
    t = time.perf_counter()
    tally = run.check(keep, seed, control)
    win.update(setup_s=setup_s, check_s=time.perf_counter() - t)
    e2e = {m["name"]: {"value": win[m["name"]], "unit": m["unit"]}
           for m in run.spec["end_to_end"]}
    return dict(win=win, e2e=e2e, per_layer=per_layer, extra=extra,
                tally=tally, peak=peak,
                attempted=win["steps"] * run.entry.answers_per_step)


def result_line(run: Run, m: dict, trace: bool) -> dict:
    torch = run.torch
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if run.cuda
              else "cpu", "count": 1, "memory_peak_bytes": m["peak"]}
    out = {"correct": m["tally"].correct, "attempted": m["attempted"],
           "failed": m["tally"].failed}
    if trace:
        device.update(busy_s=m["extra"]["busy_s"],
                      window_s=m["extra"]["window_s"])
        out.update(metrics=m["per_layer"], device=device,
                   breakdown=m["extra"]["breakdown"])
    else:
        out.update(metrics=m["e2e"], device=device)
    out["checks"] = m["tally"].lines()
    return out


def report(run: Run, m: dict) -> None:
    """What the check compared and the run's parts, on standard error;
    the numbers compared, each beside its limit, last."""
    info = {k: v for k, v in m["win"].items() if k != "setup_s"}
    print(json.dumps({"setup_parts_s": run.parts, "window": info,
                      "followed_ties": m["tally"].followed,
                      "answers_checked": m["tally"].checked,
                      **({"launch_calls_per_step": m["extra"]["launch_calls"]}
                         if m["extra"] else {})}), file=sys.stderr)
    for name, v in m["tally"].lines().items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
