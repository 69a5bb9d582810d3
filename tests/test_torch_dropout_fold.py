"""The channel dropout folded into K4-K6, on the CPU.

Where a channel dropout follows a K4 in bf16 training (the RDB convs and
the transitions through ``conv3d_in_relu_ad``, the DualAttention's norm
and the heads' second norm through ``in_relu_ad``), the model hands the
site's keep table (``Dropout.table``) to the autograd function, whose K4
applies it forward and K5 and K6 backward.  On the CPU the wrappers run
their plain versions, which apply it as the eager
``torch.where(keep, y / keep_prob, 0)`` does, so a training step's loss
and every gradient equal the eager route's (``Dropout.table`` patched to
None: every site then calls ``Dropout.channels``) to the bit, drawing
the same masks from each unit's generator in the same order.
"""

import pytest
import torch

from mica_tpu_torch.models import mica
from mica_tpu_torch.models.mica import MICA, Dropout
from mica_tpu_torch.ops import conv3d_in


def folded_sites(base: int, remat: bool):
    """(K4 launches that apply a table, K6 launches that do) of a bf16
    training step: the RDB and transition sites K1 takes (``k1_takes``),
    the 3 DualAttention norms and the 3 heads' second norms, with the RDB,
    DualAttention and heads forwards again under recomputation."""
    k1 = [conv3d_in.k1_takes(cis, co) for cis, co, st in conv3d_in.k1_sites(base) if st]
    rdb = sum(t for i, t in enumerate(k1) if i % 4 < 3)
    fwd = sum(k1) + 3 + 3
    return fwd + (rdb + 3 + 3 if remat else 0), fwd


def _step(base, remat, rate, monkeypatch, eager: bool):
    """A bf16 training step (loss, gradients), the tables K4 and K6 took,
    and the (shape, seed) of each draw from a unit's generator."""
    tables, bwd, draws = [], [], []
    k4, k6, rand = conv3d_in.in_apply_ad, conv3d_in.in_bwd_apply, torch.rand

    def in_apply_ad(c, mean, scale, drop=None):
        if drop is not None:
            tables.append(drop)
        return k4(c, mean, scale, drop=drop)

    def in_bwd_apply(*a, drop=None):
        bwd.append(drop)
        return k6(*a, drop=drop)

    def recorded_rand(*a, generator=None, **k):
        draws.append((tuple(a[0]), generator.initial_seed()))
        return rand(*a, generator=generator, **k)

    model = MICA(base=base, dtype=torch.bfloat16, remat=remat).init_weights(
        torch.Generator().manual_seed(2))
    x = torch.rand(2, 8, 8, 8, 1, generator=torch.Generator().manual_seed(0))
    af = (torch.rand(2, 8, 8, 8, 24, generator=torch.Generator().manual_seed(1)) < 0.1).float()
    with monkeypatch.context() as m:
        m.setattr(conv3d_in, "in_apply_ad", in_apply_ad)
        m.setattr(conv3d_in, "in_bwd_apply", in_bwd_apply)
        m.setattr(torch, "rand", recorded_rand)
        if eager:
            m.setattr(Dropout, "table", lambda self, *a: None)
        outs = model(x, af, train=True, dropout_rate=rate,
                     generator=torch.Generator().manual_seed(3))
        loss = sum((o.float() ** 2).mean() for o in outs)
        loss.backward()
    grads = [loss.detach()] + [p.grad for p in model.parameters()]
    return grads, tables, [d for d in bwd if d is not None], draws


@pytest.mark.parametrize("rate", [0.01, 0.3])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("base", [16, 64])
def test_folded_dropout_step_is_the_eager_one_to_the_bit(monkeypatch, base, remat, rate):
    got, tables, bwd, draws = _step(base, remat, rate, monkeypatch, eager=False)
    want, none, _, eager_draws = _step(base, remat, rate, monkeypatch, eager=True)
    assert none == []
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the same masks: the same shapes from each unit's generator, in order
    assert draws == eager_draws and len(draws) > len(tables)
    assert (len(tables), len(bwd)) == folded_sites(base, remat)
    # the transitions drop at half the rate, the heads at twice it
    rates = {mica.keep_prob(r, torch.bfloat16) for r in (rate / 2, rate, 2 * rate)}
    for keep, keep_prob in tables + bwd:
        assert keep.dtype == torch.bool and keep.shape[0] == 2 and keep_prob in rates
    if rate == 0.3:
        # every folded site dropped a channel and kept one
        assert all(not keep.all() and keep.any() for keep, _ in tables)


def test_rate_zero_draws_no_table():
    x = torch.ones(2, 3, 3, 3, 8, dtype=torch.bfloat16)
    d = Dropout(4)
    assert d.table(2, 8, 0.0, x) is None and d._gen is None
    assert d.channels(x, 0.0) is x


@pytest.mark.parametrize("rows", [None, (2, 4)])
def test_table_is_the_channel_mask(rows):
    """``table`` draws ``channels``' mask, the whole batch's rows sliced
    under data parallelism, and ``drop_plain`` applies it as
    ``channels`` does."""
    x = torch.randn(2, 3, 3, 3, 16).to(torch.bfloat16)
    for rate in (0.01, 0.5):
        keep, keep_prob = Dropout(9, rows).table(2, 16, rate, x)
        assert keep.shape == (2, 16) and keep.dtype == torch.bool
        want = Dropout(9, rows).channels(x, rate)
        assert torch.equal(conv3d_in.drop_plain(x, (keep, keep_prob)), want)
        if rows is not None:
            whole, _ = Dropout(9).table(4, 16, rate, x)
            assert torch.equal(keep, whole[2:])
