"""launches.<link|live>: device kernels, copies and fills a step in the
trace."""


def read(ctx: dict):
    tr = ctx["trace"]
    return len(tr["device"]) / tr["steps"] if tr["device"] else None
