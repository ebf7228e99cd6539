"""Runtime calls that put work on the card (kernel and graph launches,
copies, fills) per call in the traced sub-window."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["launches"]:
        return None
    return sum(t["launches"].values()) / t["calls"]
