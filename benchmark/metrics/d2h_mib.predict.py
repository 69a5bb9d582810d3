"""MiB a map copied from the card to the host: counter ``d2h_bytes`` (the
normalized map in ``pipeline.prepare``, the four volumes in
``engine.d2h``)."""

from benchmark.metrics._spans import per_unit


def read(run):
    got = per_unit(run, "predict")
    if got is None:
        return None
    spans, n = got
    return spans.counter("d2h_bytes") / 2 ** 20 / n
