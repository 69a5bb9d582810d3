"""ms a step of the traced steps' idle device time put down to the
program's own spans: gaps whose innermost host event at their middle is a
``train.*`` span."""

from benchmark.metrics._spans import idle_ms


def read(run):
    return idle_ms(run, "train")
