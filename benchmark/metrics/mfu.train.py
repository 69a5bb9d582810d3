"""The steps' operations in the window (forward and backward as three
forwards a sample, recomputation not counted, from shapes) over the
window's seconds times 989 TFLOP/s, in %."""

from benchmark import counts


def read(run):
    recs = run.driver.records if run.kind == "train" else []
    if not recs:
        return None
    cfg = run.cfg
    per = counts.forward_flops(int(cfg["base_filters"]), int(cfg["window"]), True)
    n = sum(r["samples"] for r in recs)
    return 100.0 * 3 * n * per / (run.window_s * counts.PEAK_BF16)
