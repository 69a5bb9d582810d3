"""Samples of every step of the window, each from the loader through the
optimizer's update, over the window's seconds (which end at a step's
synchronize)."""


def read(run):
    if run.kind != "train" or not run.driver.records:
        return None
    return sum(r["samples"] for r in run.driver.records) / run.window_s
