"""`device_idle_pct` and its variants (%, trace): the share of the traced
window in which no operation runs on the card (the union of its kernels,
copies and sets); on several cards the mean of the ranks."""

REDUCE = "mean"


def read(ctx):
    return None if ctx.timeline is None else ctx.timeline.idle_pct()
