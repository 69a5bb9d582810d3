"""The traced window's share in which no operation ran on the card, in %:
1 - (the union of device operations' intervals) / (the window)."""


def read(run):
    p = run.profile
    if run.kind != "train" or p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
