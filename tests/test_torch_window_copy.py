"""K9/K10's plain versions against the JAX package's DMA kernels in
interpret mode, on the CPU: pure data movement, so exact equality.

Geometries of ``tests/test_window_dma.py``: with and without AF, unaligned
starts, and a tail that must be skipped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.ops.window_dma import gather_windows_dma, scatter_cores_dma
from mica_tpu_torch.ops import window_copy as wc

STARTS = np.array([[0, 0, 0], [24, 24, 24], [48, 0, 24], [13, 7, 41], [48, 48, 48]], np.int32)


@pytest.mark.parametrize("with_af", [True, False])
@pytest.mark.parametrize("extent,w,starts", [
    (80, 32, STARTS),
    (48, 16, np.array([[0, 0, 0], [16, 16, 16]], np.int32)),
])
def test_gather_matches_dma_kernel(rng, extent, w, starts, with_af):
    pm = rng.random((extent,) * 3).astype(np.float32)
    pa = (rng.random((extent,) * 3) * 2 ** 24).astype(np.uint32) if with_af else None
    want = gather_windows_dma(jnp.asarray(pm), None if pa is None else jnp.asarray(pa),
                              jnp.asarray(starts), window=w, interpret=True)
    st = wc.starts_tensor(starts, pm.shape, w, "cpu")
    assert st.dtype == torch.int32
    before = dict(wc.launches)
    got = wc.gather_windows(torch.from_numpy(pm),
                            None if pa is None else torch.from_numpy(pa.view(np.int32)), st, w)
    assert wc.launches == before  # CPU tensors take the plain version
    if with_af:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[1].numpy().view(np.uint32), np.asarray(want[1]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_valid", [4, 0, 5])
def test_scatter_matches_dma_kernel_and_skips_tail(rng, n_valid):
    p, c, a, n = 80, 24, 4, 5
    starts = np.array([[0, 0, 0], [24, 24, 24], [48, 0, 24], [48, 48, 48], [0, 48, 48]], np.int32)
    vols = [rng.random((p, p, p)).astype(np.float32), rng.random((p, p, p)).astype(np.float32),
            rng.random((p, p, p, a)).astype(np.float32)]
    cores = [rng.random((n, c, c, c)).astype(np.float32),
             rng.random((n, c, c, c)).astype(np.float32),
             rng.random((n, c, c, c, a)).astype(np.float32)]
    want = scatter_cores_dma(tuple(jnp.asarray(v) for v in vols),
                             tuple(jnp.asarray(t) for t in cores), jnp.asarray(starts),
                             n_valid, core=c, interpret=True)
    tv = tuple(torch.from_numpy(v.copy()) for v in vols)
    got = wc.scatter_cores(tv, tuple(torch.from_numpy(t) for t in cores),
                           wc.starts_tensor(starts, (p, p, p), c, "cpu"), n_valid, c)
    for g, v, w_ in zip(got, tv, want):
        assert g is v  # written in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    if n_valid < n:  # the tail's target block is untouched
        x, y, z = starts[-1]
        np.testing.assert_array_equal(got[0].numpy()[x:x + c, y:y + c, z:z + c],
                                      vols[0][x:x + c, y:y + c, z:z + c])


def test_starts_are_checked_on_the_host():
    with pytest.raises(ValueError):
        wc.starts_tensor(np.array([[0, 0, 70]]), (80, 80, 80), 16, "cpu")
    with pytest.raises(ValueError):
        wc.starts_tensor(np.array([[-1, 0, 0]]), (80, 80, 80), 16, "cpu")
    with pytest.raises(ValueError):
        wc.starts_tensor(np.zeros((2, 2), np.int32), (80, 80, 80), 16, "cpu")
