"""ms a map of the traced map's idle device time put down to the program's
own spans: gaps whose innermost host event at their middle is a
``pipeline.*`` or ``engine.*`` span."""

from benchmark.metrics._spans import idle_ms


def read(run):
    return idle_ms(run, "predict")
