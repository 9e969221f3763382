"""Device idle share of the traced window's whole snapshot builds:
1 - (union of the CUDA intervals) / (the window's wall time)."""


def read(t):
    if not t.counts.get("builds"):
        return None
    return 1.0 - t.busy_s / t.window_s
