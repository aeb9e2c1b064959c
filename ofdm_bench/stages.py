"""The program's own stage spans and counters, read from the traced
sub-window.

The port annotates its two benchmarked steps (``utils/profiling.py`` in
the program): a root span a step, ``ofdm.chain_step`` (``chain_batch``)
or ``ofdm.chunk_step`` (``BatchReacqStreamingRx.push``), and inside it one
span a stage, ``ofdm.<stage>``; while the profiler records, a chunk step
also keeps the counters ``ofdm.detections`` and ``ofdm.slots``.  The spans
are host events of the same trace as the device's, on the profiler's
clock.  A program without them (a parent that predates them, or a step
replayed without its Python) gives no root span, and every reading here is
None.

A device operation belongs to the innermost ``ofdm.*`` span open at its
launch call: the trace's launch calls and device operations, each in
order of their start, are paired one to one, as they are on one stream
(:func:`attributed`, which also says what is done where the profiler
lost device events).
"""

from __future__ import annotations

import bisect
import statistics

from .devtrace import LAUNCH_CALL, busy_intervals, intersect, step_spans

PREFIX = "ofdm."
ROOTS = ("ofdm.chain_step", "ofdm.chunk_step")
TOP = 10


def program_spans(tr: dict) -> list:
    """The ``ofdm.*`` host spans [(name, start_us, end_us)], ordered by
    start, the outer of two that start together first."""
    return sorted(((n, s, e) for n, s, e in tr["host"]
                   if n.startswith(PREFIX)), key=lambda x: (x[1], -x[2]))


def roots(tr: dict) -> list:
    """The root spans [(start_us, end_us)], in order."""
    return [(s, e) for n, s, e in program_spans(tr) if n in ROOTS]


def _union_us(spans) -> float:
    return sum(e - s for s, e in _merge(spans))


def _merge(spans) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def stage_ms(tr: dict, stage: str) -> list:
    """Each root span's milliseconds in spans named ``stage``, in order."""
    spans = program_spans(tr)
    mine = [(s, e) for n, s, e in spans if n == stage]
    return [_union_us([(s, e) for s, e in mine if r0 <= s and e <= r1]) / 1e3
            for r0, r1 in roots(tr)]


def median_stage_ms(tr: dict, stage: str) -> float | None:
    """The median over the traced steps of :func:`stage_ms`; None where
    the trace holds no such span."""
    if not any(n == stage for n, _, _ in program_spans(tr)):
        return None
    ms = stage_ms(tr, stage)
    return float(statistics.median(ms)) if ms else None


def root_self_ms(tr: dict) -> list:
    """Each root span's milliseconds outside its stage spans: Python
    between stages, and work no stage covers."""
    spans = program_spans(tr)
    out = []
    for r0, r1 in roots(tr):
        inner = [(s, e) for n, s, e in spans
                 if n not in ROOTS and r0 <= s and e <= r1]
        out.append((r1 - r0 - _union_us(inner)) / 1e3)
    return out


def innermost(spans: list, times) -> list:
    """The name of the innermost span of ``spans`` (ordered as
    :func:`program_spans` orders them, nested or apart, as one thread's
    are) open at each of the ordered ``times`` (start <= t < end), or
    None."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][1] <= t:
            while stack and stack[-1][2] <= spans[k][1]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def launch_calls(tr: dict) -> list:
    """The host's launch calls, their starts in order (us)."""
    return sorted(s for n, s, _ in tr["host"] if LAUNCH_CALL.match(n))


def attributed(tr: dict) -> tuple[list, int] | None:
    """([(device operation, owner)], the steps they cover): each device
    operation with the innermost ``ofdm.*`` span open at its launch call
    (None outside every span).

    Where the trace holds as many device operations as launch calls: every
    operation, over every root span.  Where the profiler lost one device
    event: the operations of every step but the one it fell in, found as
    the one step k for which every step before k, paired in place, and
    every step after k, paired one operation back, launch the same
    sequence of kernel names.  None in every other case: no root span,
    more device operations than calls, more than one lost, no such k or
    more than one (a loss at the trace's first operation cannot be told
    from one at its last by the names alone)."""
    rs, calls = roots(tr), launch_calls(tr)
    ops = sorted(tr["device"], key=lambda x: x[1])
    lost = len(calls) - len(ops)
    if not rs or not calls or lost not in (0, 1):
        return None
    who = innermost(program_spans(tr), calls)
    if not lost:
        return list(zip(ops, who)), len(rs)
    blocks = [(bisect.bisect_left(calls, r0), bisect.bisect_right(calls, r1))
              for r0, r1 in rs]

    def names(a, b, d):
        return tuple(op[0] for op in ops[a - d:b - d]) \
            if 0 <= a - d and b - d <= len(ops) else None

    fits = []
    for k in range(len(blocks)):
        seqs = ([names(a, b, 0) for a, b in blocks[:k]] +
                [names(a, b, 1) for a, b in blocks[k + 1:]])
        if seqs and None not in seqs and len(set(seqs)) == 1:
            fits.append(k)
    if len(fits) != 1:
        return None
    k = fits[0]
    return [(ops[j - (i > k)], who[j]) for i, (a, b) in enumerate(blocks)
            if i != k for j in range(a, b)], len(blocks) - 1


def device_ms(tr: dict, stage: str) -> float | None:
    """Device milliseconds a step of the operations launched in
    ``stage`` (:func:`attributed`)."""
    got = attributed(tr)
    if got is None:
        return None
    pairs, steps = got
    return sum(e - s for (_, s, e), o in pairs if o == stage) / 1e3 / steps


def launches(tr: dict, stage: str) -> float | None:
    """Device operations a step launched in ``stage``: the host's launch
    calls there, one operation each, so a device event the profiler lost
    does not move it."""
    n = len(roots(tr))
    if not n:
        return None
    return innermost(program_spans(tr), launch_calls(tr)).count(stage) / n


def program_counters() -> dict | None:
    """The program's counters since the process began or they were reset
    ({name: (total, records)}), or None for a program without them."""
    from lte_gnu_radio_code_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    return read() if read else None


def occupancy(counts: dict | None) -> float | None:
    """Percent of the detection slots that held a detection:
    100 x sum ofdm.detections / sum ofdm.slots."""
    if not counts or not counts.get("ofdm.slots", (0, 0))[0]:
        return None
    return 100.0 * counts.get("ofdm.detections", (0, 0))[0] / \
        counts["ofdm.slots"][0]


def idle_intervals(tr: dict) -> list:
    """The device's idle intervals inside the traced steps' own spans
    (``devtrace.step_spans``), as ``devtrace.breakdown`` takes them."""
    busy = busy_intervals(tr["device"])
    out = []
    for s, e in step_spans(tr):
        edges = [s] + [x for b in intersect(busy, [[s, e]]) for x in b] + [e]
        out += [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    return out


def idle_ms(tr: dict) -> dict:
    """Idle milliseconds a step by the innermost ``ofdm.*`` span open
    (None: outside every span)."""
    spans = program_spans(tr)
    cuts = sorted({x for _, s, e in spans for x in (s, e)})
    pieces = []
    for a, b in idle_intervals(tr):
        edges = [a] + cuts[bisect.bisect_right(cuts, a):
                           bisect.bisect_left(cuts, b)] + [b]
        pieces += list(zip(edges, edges[1:]))
    pieces.sort(key=lambda p: (p[0] + p[1]) / 2)
    who = innermost(spans, [(a + b) / 2 for a, b in pieces])
    out: dict = {}
    for (a, b), o in zip(pieces, who):
        out[o] = out.get(o, 0.0) + (b - a) / 1e3
    n = max(1, len(roots(tr)))
    return {k: v / n for k, v in out.items()}


def gap_owners(tr: dict, top: int = TOP) -> list:
    """The innermost ``ofdm.*`` span (or None) at the midpoint of each of
    the ``top`` longest idle gaps, the point ``devtrace.breakdown`` names a
    gap by, longest first: [(name, ms)]."""
    gaps = sorted(idle_intervals(tr), key=lambda g: g[0] - g[1])[:top]
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    who = innermost(program_spans(tr), [m for m, _ in mids])
    return sorted(((o, d / 1e3) for o, (_, d) in zip(who, mids)),
                  key=lambda x: -x[1])


def summary(tr: dict) -> dict:
    """Every stage's host ms (median), device ms, launches and idle ms a
    step; the root spans' ms and own ms (medians) and their share; the
    owners of the longest idle gaps."""
    names = sorted({n for n, _, _ in program_spans(tr) if n not in ROOTS})
    idle = idle_ms(tr)
    stages = {n: dict(host_ms=median_stage_ms(tr, n),
                      device_ms=device_ms(tr, n), launches=launches(tr, n),
                      idle_ms=idle.get(n, 0.0)) for n in names}
    rs = roots(tr)
    root_ms = [(e - s) / 1e3 for s, e in rs]
    own = root_self_ms(tr)
    gaps = gap_owners(tr)
    return dict(
        stages=stages, steps=len(rs),
        root_ms=statistics.median(root_ms) if rs else None,
        root_self_ms=statistics.median(own) if rs else None,
        root_self_share_max=(max(o / r for o, r in zip(own, root_ms))
                         if rs else None),
        root_device_ms=device_ms(tr, next(
            (n for n, _, _ in program_spans(tr) if n in ROOTS), None)),
        root_idle_ms={k: v for k, v in idle.items() if k not in stages},
        gaps=gaps, gaps_in_spans=sum(o is not None for o, _ in gaps))
