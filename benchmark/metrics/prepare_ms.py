"""ms a map in ``prepare_map`` (span ``pipeline.prepare``): the map read,
its copy to the card, resampled and normalized there, and copied back."""

from benchmark.metrics._spans import per_unit


def read(run):
    got = per_unit(run, "predict")
    if got is None:
        return None
    spans, n = got
    return 1e3 * spans.total_s("pipeline.prepare") / n
