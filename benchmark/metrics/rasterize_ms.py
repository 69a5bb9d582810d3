"""ms a map in ``build_af3_encoding`` (span ``pipeline.rasterize``): the
docked model parsed and rasterized into the 24-channel AF3 encoding."""

from benchmark.metrics._spans import per_unit


def read(run):
    got = per_unit(run, "predict")
    if got is None or not got[0].n_spans("pipeline.rasterize"):
        return None
    spans, n = got
    return 1e3 * spans.total_s("pipeline.rasterize") / n
