"""ms a batch forward of device kernels that are not the port's own (cuDNN
and cuBLAS convs and products, aten's elementwise and reductions) in the
traced map."""

from benchmark import counts


def read(run):
    p = run.profile
    if run.kind != "predict" or p is None or not run.driver.traced["n_forwards"]:
        return None
    return 1e3 * p.seconds(counts.is_library) / run.driver.traced["n_forwards"]
