"""ms a step in ``Trainer._to_device`` (span ``train.to_device``): the
batch's copy from pageable host memory, with whatever wait for the card
it meets."""

from benchmark.metrics._spans import per_unit


def read(run):
    got = per_unit(run, "train")
    if got is None:
        return None
    spans, n = got
    return 1e3 * spans.total_s("train.to_device") / n
