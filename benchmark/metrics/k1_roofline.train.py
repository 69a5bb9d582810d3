"""K1's share of its roofline in the traced window (train): the larger of
its launches' operations over 989 TFLOP/s and bytes over 3.35 TB/s, summed
over the launches, over K1's device time (both of its kernels) in %."""

from benchmark.metrics._k1 import roofline


def read(run):
    return roofline(run, "train")
