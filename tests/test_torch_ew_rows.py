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


def _k12_emulated(x, dy, b_sz):
    """K12 as ``k12_plan`` lays it out: each program's (b_sz, 2, block_c)
    partial over its chunk of N and its row block into its own block of
    the buffer (NaN until written: the card does not zero it), then the
    blocks summed in order."""
    d, h, r, c = x.shape
    plan = ew_rows.k12_plan(x.shape, b_sz)
    g = torch.where(x > 0, dy, torch.zeros((), dtype=dy.dtype)).float().reshape(d * h, r, c)
    buf = torch.full((plan["partials"], b_sz, 2, c), float("nan"))
    for i in range(plan["n_chunks"]):
        n = g[i * plan["chunk"]:(i + 1) * plan["chunk"]]
        for j in range(plan["n_r"]):
            rows = n[:, j * plan["block_r"]:(j + 1) * plan["block_r"]].sum(0)
            # row k of the tile is in batch k mod b_sz; a missing row is zero
            rows = torch.cat([rows, rows.new_zeros(plan["block_r"] - len(rows), c)])
            sq = (n[:, j * plan["block_r"]:(j + 1) * plan["block_r"]] ** 2).sum(0)
            sq = torch.cat([sq, sq.new_zeros(plan["block_r"] - len(sq), c)])
            blk = i * plan["n_r"] + j
            buf[blk, :, 0] = rows.view(-1, b_sz, c).sum(0)
            buf[blk, :, 1] = sq.view(-1, b_sz, c).sum(0)
    assert not torch.isnan(buf).any()
    return buf.sum(0), plan


@pytest.mark.parametrize("shape,b_sz", [((4, 3, 40, 24), 8), ((2, 5, 64, 160), 8),
                                        ((3, 2, 16, 32), 16)])
def test_k12_plan_partials_cover_each_row_once(shape, b_sz):
    """The partial blocks of ``k12_plan`` cover every (n, r, c) once, with
    row blocks a multiple of b_sz, and their sum is the plain version's."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to(torch.bfloat16)
    dy = torch.randn(shape, generator=g).to(torch.bfloat16)
    got, plan = _k12_emulated(x, dy, b_sz)
    d, h, r, c = shape
    assert plan["block_r"] % b_sz == 0 and plan["n_r"] * plan["block_r"] >= r
    assert plan["n_c"] * plan["block_c"] >= c
    assert (plan["n_chunks"] - 1) * plan["chunk"] < d * h <= plan["n_chunks"] * plan["chunk"]
    want = ew_rows.masked_sq_stats_plain(x, dy, b_sz)
    mag = ew_rows.masked_sq_stats_plain(x, dy.abs(), b_sz)
    assert ((got - want).abs() <= 1e-5 * mag + 1e-6).all()
