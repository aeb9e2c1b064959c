"""idle_share.<link|live>: the share of the traced steps' own spans (each
from its enqueue's start to its last device operation's end) in which no
operation ran on the device, in percent.  The open loop's wait for a due
time lies outside every span, so the share shows how far the host holds
the card back inside a step, not how far the offered rate leaves it idle."""

from ofdm_bench.devtrace import busy_intervals, intersect, step_spans


def read(ctx: dict):
    tr = ctx["trace"]
    spans = step_spans(tr)
    if not spans or not tr["device"]:
        return None
    busy = intersect(busy_intervals(tr["device"]), spans)
    total = sum(e - s for s, e in spans)
    return 100.0 * (1.0 - sum(e - s for s, e in busy) / total)
