"""ms a training step of device kernels that are not the port's own
(cuDNN and cuBLAS convs, their weight gradients, aten's elementwise,
reductions, dropout and Adam) in the traced steps."""

from benchmark import counts


def read(run):
    p = run.profile
    if run.kind != "train" or p is None or not run.driver.traced:
        return None
    return 1e3 * p.seconds(counts.is_library) / len(run.driver.traced)
