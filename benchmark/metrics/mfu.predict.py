"""The network's operations for the windows the engine computed in the
window (forwards, counted from shapes) over the window's seconds times
989 TFLOP/s, in %."""

from benchmark import counts


def read(run):
    recs = run.driver.records if run.kind == "predict" else []
    if not recs:
        return None
    cfg = run.cfg
    per = counts.forward_flops(int(cfg["base_filters"]), int(cfg["window"]),
                               cfg["protocol"] == "AF3_struct", int(cfg["core"]))
    n = sum(r["n_windows"] - r["n_empty"] for r in recs)
    return 100.0 * n * per / (run.window_s * counts.PEAK_BF16)
