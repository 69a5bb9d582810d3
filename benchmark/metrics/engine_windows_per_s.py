"""Windows the engine computed (not the empty ones it tiles) over its
inference seconds, summed over the window's maps."""


def read(run):
    recs = run.driver.records if run.kind == "predict" else []
    t = sum(r["inference"] for r in recs)
    if not recs or t <= 0:
        return None
    return sum(r["n_windows"] - r["n_empty"] for r in recs) / t
