"""K1's least time over the traced window, and the launches it assumes,
for the k1_roofline readers."""

from benchmark import counts


def least(run):
    """(least seconds, launches) of K1's launches in the traced window."""
    cfg = run.cfg
    base, win, bsz = int(cfg["base_filters"]), int(cfg["window"]), int(cfg["batch_size"])
    if run.kind == "predict":
        t = run.driver.traced
        n = t["n_windows"] - t["n_empty"]
        rows = [bsz] * (n // bsz) + ([n % bsz] if n % bsz else [])
        return counts.k1_predict_least_s(base, win, rows)
    steps = len(run.driver.traced)
    t, k = counts.k1_train_least_s(base, win, bsz)
    return steps * t, steps * k


def roofline(run, kind):
    """K1's least time over its device time, in %; nothing where the cell
    is not of ``kind``, the profile saw no K1 time, or K1 launched other
    than the count assumes."""
    p = run.profile
    if run.kind != kind or p is None:
        return None
    busy = p.seconds(counts.is_k1)
    t, launches = least(run)
    if busy <= 0 or p.launches.get("conv3d_stats") != launches:
        return None
    return 100.0 * t / busy
