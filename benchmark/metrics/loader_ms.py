"""ms a step in ``next()`` of ``batch_iterator``: the host's batching and
casting of the samples."""


def read(run):
    recs = run.driver.records if run.kind == "train" else []
    if not recs:
        return None
    return 1e3 * sum(r["loader"] for r in recs) / len(recs)
