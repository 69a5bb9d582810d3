"""ms a map of the engine's set-up (padding, occupancy, bit-packing, the
inputs' copy to the card, the zero-window tiling) and reconstruction (the
volumes' copy to the host): ``timing["setup"] + timing["reconstruction"]``."""


def read(run):
    recs = run.driver.records if run.kind == "predict" else []
    if not recs:
        return None
    return 1e3 * sum(r["setup"] + r["reconstruction"] for r in recs) / len(recs)
