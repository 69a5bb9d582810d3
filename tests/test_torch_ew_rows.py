"""K11/K12's plain versions, through the port's ``distill_ew_crash``, against
the TPU script's ten Pallas variants in interpret mode, on the CPU.

The TPU script (``scripts/distill_ew_crash.py``; ``scripts/`` is no
package) is loaded from its file with its sizes cut to (D, H, R, C, B_SZ)
= (2, 8, 16, 128, 8).  Both sides get the same bf16 values.  Bodies k1-k4
round each bf16 op once on both sides: bitwise equal.  k5's f32 sums run
in another order: within 1e-5 of the sum of the terms' magnitudes.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mica_tpu_torch.ops import ew_rows
from mica_tpu_torch.scripts import distill_ew_crash as port

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "distill_ew_crash.py"
SIZES = dict(D=2, H=8, R=16, C=128, B_SZ=8)


@pytest.fixture
def tpu_script(monkeypatch):
    spec = importlib.util.spec_from_file_location("tpu_distill_ew_crash", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in SIZES.items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return mod


def _inputs():
    """The TPU script's inputs at the cut sizes, and the same values as
    torch tensors."""
    rng = np.random.default_rng(0)
    d, h, r, c = SIZES["D"], SIZES["H"], SIZES["R"], SIZES["C"]
    jx = {"x": jnp.asarray(rng.standard_normal((d, h, r, c)), jnp.bfloat16),
          "ms2": jnp.asarray(rng.standard_normal((2, r, c)), jnp.float32),
          "ms3": jnp.asarray(rng.standard_normal((3, r, c)), jnp.float32),
          "dy": jnp.asarray(rng.standard_normal((d, h, r, c)), jnp.bfloat16)}
    tx = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in jx.items()}
    return jx, tx


@pytest.mark.parametrize("variant", port.VARIANTS)
def test_variant_matches_pallas(tpu_script, variant):
    jx, tx = _inputs()
    want = jax.tree_util.tree_leaves(
        jax.jit(tpu_script.build(variant))(*port.args_of(variant, jx)))
    before = dict(ew_rows.launches)
    got = port.run_variant(variant, tx, "cpu")
    assert ew_rows.launches == before   # CPU tensors take the plain versions
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        if variant != "accum3":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(), w)
        else:
            mag = ew_rows.masked_sq_stats_plain(tx["x"], tx["dy"].abs())
            assert np.all(np.abs(g.numpy() - w) <= 1e-5 * mag.numpy() + 1e-6)


def test_make_inputs_draws_the_tpu_scripts_values():
    jx, _ = _inputs()
    got = port.make_inputs("cpu", SIZES["D"], SIZES["H"], SIZES["R"], SIZES["C"])
    for k, v in jx.items():
        assert got[k].dtype == (torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(v, np.float32))


def test_in_place_variants_write_their_argument():
    """On the CPU too, ``out`` receives y: x for base, dy for twoin_al."""
    _, tx = _inputs()
    x, dy = tx["x"].clone(), tx["dy"].clone()
    y = port.build("base", "cpu")(x, tx["ms2"])
    assert y is x and torch.equal(x, ew_rows.rows_ew_plain(tx["x"], tx["ms2"], "k1"))
    y = port.build("twoin_al", "cpu")(tx["x"], dy, tx["ms2"])
    assert y is dy and torch.equal(dy, ew_rows.rows_ew_plain(tx["x"], tx["ms2"], "k4", tx["dy"]))


def test_k3_rounds_each_op():
    """k3 = (x - m)·s + t with a bf16 rounding after each op, the same
    expression in f32 with explicit rounds."""
    _, tx = _inputs()
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    m, s, t = (r(v) for v in tx["ms3"])
    want = r(r(r(tx["x"].float() - m) * s) + t)
    assert torch.equal(ew_rows.rows_ew(tx["x"], tx["ms3"], "k3").float(), want)


def test_k5_groups_rows_by_r_mod_b():
    """The batch of a row is r mod b_sz for any R, not only R % b_sz == 0."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 2, 13, 5, generator=g).to(torch.bfloat16)
    dy = torch.randn(3, 2, 13, 5, generator=g).to(torch.bfloat16)
    got = ew_rows.masked_sq_stats(x, dy, b_sz=4)
    gf = torch.where(x > 0, dy, 0).double()
    for b in range(4):
        sel = gf[:, :, b::4]
        torch.testing.assert_close(got[b, 0].double(), sel.sum(dim=(0, 1, 2)), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[b, 1].double(), (sel * sel).sum(dim=(0, 1, 2)),
                                   rtol=1e-6, atol=1e-6)


def test_wrapper_refuses_a_body_without_its_inputs():
    _, tx = _inputs()
    with pytest.raises(ValueError):
        ew_rows.rows_ew(tx["x"], tx["ms2"], "k4")
    with pytest.raises(ValueError):
        ew_rows.rows_ew(tx["x"], tx["ms2"], "k1", dy=tx["dy"])
    with pytest.raises(ValueError):
        port.build("nope", "cpu")
