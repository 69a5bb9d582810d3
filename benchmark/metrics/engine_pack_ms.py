"""ms a map of the engine's host work on its inputs: the self time of
spans ``engine.pad`` (the halo pads), ``engine.pack`` (the AF3 0/1 check,
the bit packing and its int32 view) and ``engine.occupancy`` (the
windows' occupancy test)."""

from benchmark.metrics._spans import per_unit


def read(run):
    got = per_unit(run, "predict")
    if got is None:
        return None
    spans, n = got
    return 1e3 * sum(spans.self_s(k) for k in ("engine.pad", "engine.pack",
                                                "engine.occupancy")) / n
