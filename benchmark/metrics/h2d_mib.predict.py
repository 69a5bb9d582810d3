"""MiB a map copied from the host to the card: counter ``h2d_bytes`` (the
raw map in ``pipeline.prepare``, the padded map and packed AF3 encoding in
``engine.h2d``)."""

from benchmark.metrics._spans import per_unit


def read(run):
    got = per_unit(run, "predict")
    if got is None:
        return None
    spans, n = got
    return spans.counter("h2d_bytes") / 2 ** 20 / n
