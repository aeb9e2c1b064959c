"""live_backlog_max: the most chunk steps past due and not yet complete
on the device at any one time in the window."""


def read(ctx: dict):
    return ctx.get("window", {}).get("backlog_max")
