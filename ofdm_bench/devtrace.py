"""The traced sub-window: a torch.profiler trace of some tens of steps,
reduced to what the per-layer metrics read.

The capture follows the program's own ``chip_smoke.py:trace``: the
profiler now and then loses a part of a trace's device events on the H100
host, so a trace with fewer device events than the host's launch calls is
taken again, and the fullest kept.
"""

from __future__ import annotations

import re
import time

LAUNCH_CALL = re.compile(r"cu(da)?(Launch|Memcpy|Memset)")
TRIES = 4
TOP = 10
STEP = "harness.step"


def capture(run, torch) -> dict:
    """Trace run() and reduce it: device events [(name, start_us,
    end_us)], host operators [(name, start_us, end_us)], the host's launch
    calls, and the sub-window's wall seconds on the host's clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device, host, made = [], [], 0
        for e in prof.events():
            span = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    device.append(span)     # a harness span is no device work
            elif e.device_type == DeviceType.CPU:
                host.append(span)
                made += bool(LAUNCH_CALL.match(e.name))
        got = dict(device=device, host=host, launch_calls=made,
                   window_s=wall, steps=steps)
        if best is None or len(device) > len(best["device"]):
            best = got
        if len(device) >= made:
            break
    return best


def busy_intervals(device: list) -> list:
    """The union of the device events' intervals, in order (us)."""
    return merge((s, e) for _, s, e in device)


def busy_s(device: list) -> float:
    return sum(e - s for s, e in busy_intervals(device)) / 1e6


def merge(spans) -> list:
    """The union of [start, end] intervals, in order."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def step_spans(tr: dict) -> list:
    """Each traced step's own span (us), merged where they touch: from the
    start of its ``harness.step`` host span to the end of that span or of
    the last device operation that began before the next step's start,
    whichever is later.  A wait between steps lies outside."""
    steps = sorted((s, e) for n, s, e in tr["host"] if n == STEP)
    dev = sorted((s, e) for _, s, e in tr["device"])
    nxt = [s for s, _ in steps[1:]] + [float("inf")]
    spans, k = [], 0
    for (s0, end), s1 in zip(steps, nxt):
        while k < len(dev) and dev[k][0] < s1:
            if dev[k][0] >= s0:
                end = max(end, dev[k][1])
            k += 1
        spans.append((s0, end))
    return merge(spans)


def intersect(a: list, b: list) -> list:
    """The intersection of two ordered lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def breakdown(tr: dict) -> dict:
    """The device operations that took the most time, and the longest
    idle gaps inside the steps' own spans (``step_spans``), each named by
    the innermost host operator running at its middle."""
    ops: dict = {}
    for name, s, e in tr["device"]:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    busy = busy_intervals(tr["device"])
    idle = []
    for s, e in step_spans(tr):
        edges = [s] + [x for b in intersect(busy, [[s, e]]) for x in b] + [e]
        idle += [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                 if b > a]
    gaps = sorted(idle, reverse=True)[:TOP]
    named = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        inside = [(hs, n) for n, hs, he in tr["host"] if hs <= mid < he]
        name = max(inside)[1] if inside else "no host operator"
        named.append([name, length / 1e6])
    return {"device_ops": [[n[:160], t] for n, t in top_ops],
            "idle_gaps": [[n[:160], t] for n, t in named]}
