"""The port's span recorder (``mica_tpu_torch.utils.spans``) for the span
readers: it holds the traced window alone, the only time a profiler runs.
Nothing where the program has no recorder (a checkout older than its
spans) or recorded no map or step."""

UNIT = {"predict": "pipeline.predict_map", "train": "train.step"}


def per_unit(run, kind):
    """(the recorder, the maps or steps it recorded) for a run of ``kind``,
    or None."""
    if run.kind != kind:
        return None
    try:
        from mica_tpu_torch.utils import spans
    except ImportError:
        return None
    n = spans.n_spans(UNIT[kind])
    return (spans, n) if n else None


def idle_ms(run, kind):
    """ms a map or step of the traced window's idle device time whose gaps
    fall, at their middle, innermost in one of the program's spans."""
    got = per_unit(run, kind)
    if got is None or run.profile is None:
        return None
    spans, n = got
    names = {r.name for r in spans.recorded()}
    return 1e3 * sum(s for label, s in run.profile.idle_by_host if label in names) / n
