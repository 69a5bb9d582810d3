"""The port's MICA module against the JAX network, f32 on the CPU.

Both sides get the same numpy inputs and the same weights (the JAX tree
through ``state_dict_from_jax_params``).  Tolerance rtol/atol 1e-4: both
run f32 convs, which differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.models.convert import params_to_torch_state_dict
from mica_tpu.models.init import init_params_fast
from mica_tpu.models.mica import MICA as JaxMICA
from mica_tpu_torch.models.convert import layer_map, state_dict_from_jax_params
from mica_tpu_torch.models.mica import MICA

BASE = 16
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxMICA(base=BASE)
    return init_params_fast(
        model, (jnp.zeros((1, 8, 8, 8, 1)), jnp.zeros((1, 8, 8, 8, 24))), seed=3)


@pytest.fixture(scope="module")
def torch_model(jax_params):
    m = MICA(base=BASE, dtype=torch.float32)
    m.load_state_dict(state_dict_from_jax_params(jax_params), strict=True)
    return m.eval()


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.random((2, 16, 16, 16, 1)).astype(np.float32)
    af = (rng.random((2, 16, 16, 16, 24)) < 0.03).astype(np.float32)
    af[0] = 0.0  # sample 0 takes the density-only stem branch
    return x, af


@pytest.mark.parametrize("with_af,out_slice", [(True, None), (True, slice(2, 14)),
                                                (False, None)])
def test_model_matches_jax(jax_params, torch_model, with_af, out_slice):
    x, af = _inputs()
    af_j = jnp.asarray(af) if with_af else None
    want = JaxMICA(base=BASE).apply({"params": jax_params}, jnp.asarray(x), af_j,
                                    out_slice=out_slice)
    with torch.no_grad():
        got = torch_model(torch.from_numpy(x),
                          torch.from_numpy(af) if with_af else None,
                          out_slice=out_slice)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_state_dict_keys_round_trip(jax_params, torch_model):
    """The JAX package's own exporter and the port's carrier give the same
    keys and values, and both load strictly."""
    ref = params_to_torch_state_dict(jax_params)
    ours = state_dict_from_jax_params(jax_params)
    assert set(ref) == set(ours) == set(torch_model.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    MICA(base=BASE, dtype=torch.float32).load_state_dict(
        {k: torch.tensor(np.asarray(v)) for k, v in ref.items()}, strict=True)
    assert len(layer_map()) * 2 + 1 == len(ours)


def test_load_checkpoint_original_format(tmp_path, jax_params):
    """An original-format .pth (DataParallel prefix, model_state_dict)."""
    from mica_tpu_torch.models.convert import load_checkpoint

    sd = state_dict_from_jax_params(jax_params)
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3}, tmp_path / "ck.pth")
    loaded = load_checkpoint(str(tmp_path / "ck.pth"))
    MICA(base=BASE, dtype=torch.float32).load_state_dict(loaded, strict=True)
    assert torch.equal(loaded["fpn.weights"], sd["fpn.weights"])


def test_init_weights_is_seeded():
    a = MICA(base=BASE).init_weights(torch.Generator().manual_seed(1))
    b = MICA(base=BASE).init_weights(torch.Generator().manual_seed(1))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.allclose(a.fpn.weights, torch.full((3,), 1 / 3))
