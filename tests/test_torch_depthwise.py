"""The port's depthwise 3x3x3 (plain version, on the CPU) against the Pallas
kernel in interpret mode, f32, tolerance 1e-5 (tap order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.ops.depthwise_pallas import depthwise_conv3_pallas
from mica_tpu_torch.ops.depthwise import depthwise_conv3


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 64), (1, 8, 6, 10, 64)])
def test_depthwise_matches_pallas(rng, shape):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 1, c)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    want = depthwise_conv3_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                  interpret=True)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))
    got = depthwise_conv3(torch.from_numpy(x), w, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_depthwise_bf16_keeps_dtype(rng):
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 8)).astype(np.float32))
    w = torch.randn(8, 1, 3, 3, 3, generator=torch.Generator().manual_seed(0))
    out = depthwise_conv3(x.to(torch.bfloat16), w, torch.zeros(8))
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
