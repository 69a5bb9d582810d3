"""The port's ``bench_in_apply`` and ``probe_layout_boundary`` against the
TPU scripts of the same names, on the CPU.

Row 12: the eager apply and K2's plain version against the TPU script's
``xla_apply`` and against its Pallas ``kernel`` in interpret mode (the
call is rebuilt here from ``scripts/bench_in_apply.py:66-88``: the
kernel is local to its ``main``), in bf16, bitwise: each op rounds once
on both sides.

Row 13: K13's plain version against ``pallas_scale_bdhwc`` and
``pallas_scale_dhwbc`` in interpret mode, bitwise in bf16 (doubling is
exact); the port's ``f_direct``, ``f_transposed`` and ``f_noop`` against
the probe's in f32 within 1e-4 (two convs, f32 sums in another order).
The probe appends an HLO dump flag to ``XLA_FLAGS`` and may set
``JAX_PLATFORMS`` when imported; both are restored around each test, and
the JAX backend has read its flags before the import.

Each port script's ``main`` refuses to run without a card.
"""

import functools
import importlib
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mica_tpu_torch.ops import conv3d_in, scale
from mica_tpu_torch.scripts import bench_in_apply, probe_layout_boundary

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _pallas_apply(v, m, s):
    """``scripts/bench_in_apply.py:66-88``: blocks over (B, D) rows."""
    b, size, c = v.shape[0], v.shape[1], v.shape[-1]

    def kernel(x_ref, m_ref, s_ref, o_ref):
        o_ref[...] = jnp.maximum((x_ref[...] - m_ref[...]) * s_ref[...], 0)

    blk_d = max(1, 128 // c)
    return pl.pallas_call(
        kernel,
        grid=(b, size // blk_d),
        in_specs=[pl.BlockSpec((1, blk_d, size, size, c), lambda i, d: (i, d, 0, 0, 0)),
                  pl.BlockSpec((1, 1, 1, 1, c), lambda i, d: (i, 0, 0, 0, 0)),
                  pl.BlockSpec((1, 1, 1, 1, c), lambda i, d: (i, 0, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, blk_d, size, size, c), lambda i, d: (i, d, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(v.shape, v.dtype),
        interpret=True,
    )(v, m, s)


@pytest.mark.parametrize("c", bench_in_apply.WIDTHS)
def test_in_apply_bench_matches_tpu_script(rng, c):
    b, size = 2, 4
    v = jnp.asarray(rng.standard_normal((b, size, size, size, c), np.float32), jnp.bfloat16)
    m = jnp.asarray(rng.standard_normal((b, 1, 1, 1, c), np.float32), jnp.bfloat16)
    s = jnp.asarray(rng.standard_normal((b, 1, 1, 1, c), np.float32), jnp.bfloat16)
    tv, tm, ts = _bf16(v), _bf16(m), _bf16(s)
    want_xla = np.asarray(jnp.maximum((v - m) * s, 0), np.float32)
    want_pallas = np.asarray(_pallas_apply(v, m, s), np.float32)
    np.testing.assert_array_equal(want_xla, want_pallas)
    before = dict(conv3d_in.launches)
    got_eager = bench_in_apply.eager_apply(tv, tm, ts)
    got_k2 = bench_in_apply.k2_apply(tv, tm, ts)
    assert conv3d_in.launches == before     # CPU tensors: K2's plain version
    assert got_eager.dtype == got_k2.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_eager.float().numpy(), want_xla)
    np.testing.assert_array_equal(got_k2.float().numpy(), want_pallas)


@pytest.fixture
def probe(monkeypatch):
    """``scripts/probe_layout_boundary.py`` imported with its environment
    changes undone, its Pallas calls in interpret mode."""
    jax.jit(lambda a: a + 1)(1)     # the backend has read XLA_FLAGS
    saved = {var: os.environ.get(var) for var in ("JAX_PLATFORMS", "XLA_FLAGS")}
    for var, val in saved.items():
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    spec = importlib.util.spec_from_file_location("tpu_probe_layout_boundary",
                                                  SCRIPTS / "probe_layout_boundary.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for var, val in saved.items():
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return mod


def test_probe_import_leaves_the_environment(probe):
    assert "xla_dump_to" not in os.environ.get("XLA_FLAGS", "")


@pytest.mark.parametrize("layout", ["bdhwc", "dhwbc"])
def test_scale2_matches_pallas_scale(probe, rng, layout):
    shape = (2, 4, 8, 4, 16) if layout == "bdhwc" else (4, 8, 4, 2, 16)
    x = jnp.asarray(rng.standard_normal(shape, np.float32), jnp.bfloat16)
    want = getattr(probe, f"pallas_scale_{layout}")(x)
    before = dict(scale.launches)
    got = scale.scale2(_bf16(x))
    assert scale.launches == before
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("name", ["f_direct", "f_transposed", "f_noop"])
def test_probe_functions_match(probe, rng, name):
    """f32, (B, D, H, W) = (2, 4, 8, 4), 8 channels (the Pallas blocks need
    D % 4 == 0 and H % 8 == 0)."""
    x = rng.standard_normal((2, 4, 8, 4, 8), np.float32)
    k1, k2 = ((rng.standard_normal((3, 3, 3, 8, 8)) / np.sqrt(27 * 8)).astype(np.float32)
              for _ in range(2))
    want = getattr(probe, name)(jnp.asarray(x), jnp.asarray(k1), jnp.asarray(k2))
    w1, w2 = (probe_layout_boundary.weight_from_dhwio(torch.from_numpy(k)) for k in (k1, k2))
    got = getattr(probe_layout_boundary, name)(torch.from_numpy(x), w1, w2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("script", ["distill_ew_crash", "bench_in_apply", "probe_layout_boundary"])
def test_script_main_refuses_without_card(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    mod = importlib.import_module(f"mica_tpu_torch.scripts.{script}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
