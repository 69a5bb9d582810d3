"""MiB a step copied from the host to the card: counter ``h2d_bytes`` of
``train.to_device`` (the batch as the loader hands it over)."""

from benchmark.metrics._spans import per_unit


def read(run):
    got = per_unit(run, "train")
    if got is None:
        return None
    spans, n = got
    return spans.counter("h2d_bytes") / 2 ** 20 / n
