"""ms a map in ``predict_map`` outside the engine's ``predict_volume``:
the map read, resampled and normalized, the docked model rasterized (the
call's wall less the engine's set-up, inference and reconstruction)."""


def read(run):
    recs = run.driver.records if run.kind == "predict" else []
    if not recs:
        return None
    return 1e3 * sum(r["wall"] - r["setup"] - r["inference"] - r["reconstruction"]
                     for r in recs) / len(recs)
