"""Which sites take ``in_sums``, on the CPU.

In bf16 the InstanceNorm + ReLU that follow no K1 (the DualAttention's
after K3, twice in each head) take ``in_sums`` and then K2 at inference,
K4 in training (``in_relu_ad``), and every average pool (the stem's, the
SE blocks', the DualAttentions', the heads' calibrations) takes
``in_sums`` through ``avg_pool_ad``: 19 calls a forward,
with or without the AF3 input.  On the f32 route none does.  On the CPU
the wrappers run their plain versions, which give the library
expressions' values to the bit, so the bf16 forward, at inference and in
training, equals the one through ``instance_norm`` and
``global_avg_pool``.
"""

import numpy as np
import pytest
import torch

from mica_tpu_torch.models import mica
from mica_tpu_torch.models.mica import MICA
from mica_tpu_torch.ops import conv3d_in


def site_widths(base: int):
    """The channels ``in_sums`` sees, in order: the stem's pool; per stage
    the SE pool, the DualAttention's norm and pool; per head two norms (64,
    32) and the calibration's pool."""
    widths = [2 * base]
    for i in range(3):
        widths += [base * 2 ** i] * 3
    return widths + [64, 32, 32] * 3


@pytest.fixture
def calls(monkeypatch):
    """(wrapper, channels) of each ``in_sums`` and ``in_apply`` call the
    model makes through its own names, and of each ``in_sums`` call of the
    training route's autograd functions (``conv3d_in``'s name); each input
    must be contiguous, as the kernels take it on the card."""
    seen = []

    def record(module, name):
        fn = getattr(module, name)

        def wrapper(x, *a):
            assert x.is_contiguous(), (name, tuple(x.shape), x.stride())
            seen.append((name, x.shape[-1]))
            return fn(x, *a)
        return wrapper

    for module, name in ((mica, "in_sums"), (mica, "in_apply"), (conv3d_in, "in_sums")):
        monkeypatch.setattr(module, name, record(module, name))
    return seen


def library_in_relu(t, train, kernels, drop=None, rate=0.0):
    """``in_relu`` on the library's ``instance_norm``, then the eager
    channel dropout that the kernel route folds into K4."""
    y = torch.relu(mica.instance_norm(t))
    return y if drop is None else drop.channels(y, rate)


def _inputs(af: bool, n=1, d=4):
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.random((n, d, d, d, 1)).astype(np.float32))
    a = torch.from_numpy((r.random((n, d, d, d, 24)) < 0.1).astype(np.float32))
    return x, a if af else None


@pytest.mark.parametrize("af", [True, False])
@pytest.mark.parametrize("base", [16, 64])
def test_bf16_inference_takes_in_sums_at_all_19_sites(calls, base, af):
    model = MICA(base=base, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(*_inputs(af))
    sums = [c for name, c in calls if name == "in_sums"]
    assert sums == site_widths(base)
    # K2 through the model's own name: the 9 norms (the K1 sites call it
    # inside ``conv3d_in_relu``)
    assert [c for name, c in calls if name == "in_apply"] == [
        base, 2 * base, 4 * base] + [64, 32] * 3


@pytest.mark.parametrize("dtype,train", [(torch.bfloat16, True), (torch.float32, False),
                                         (torch.float32, True)])
def test_training_and_f32_take_the_library_statistics(calls, dtype, train):
    """The f32 route, at inference and in training, takes the library
    statistics: no call.  bf16 training takes ``in_sums`` at all 19 sites
    (through ``in_relu_ad`` and ``avg_pool_ad``) and no K2."""
    model = MICA(base=16, dtype=dtype).init_weights(torch.Generator().manual_seed(0))
    with torch.set_grad_enabled(train):
        model(*_inputs(True), train=train)
    widths = site_widths(16) if dtype == torch.bfloat16 else []
    assert calls == [("in_sums", c) for c in widths]


@pytest.mark.parametrize("af", [True, False])
@pytest.mark.parametrize("base", [16, 64])
def test_bf16_forward_is_the_library_statistics_forward_to_the_bit(monkeypatch, base, af):
    model = MICA(base=base, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(1))
    x, a = _inputs(af, n=2, d=8)
    with torch.no_grad():
        got = model(x, a)
        monkeypatch.setattr(mica, "in_relu", library_in_relu)
        monkeypatch.setattr(mica, "avg_pool", lambda t, *route: mica.global_avg_pool(t))
        want = model(x, a)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("rate", [0.0, 0.01])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("base", [16, 64])
def test_bf16_training_forward_is_the_library_statistics_forward_to_the_bit(
        monkeypatch, base, remat, rate):
    """The training twin of the test above: ``train=True`` under autograd,
    recomputation on and off, dropout 0 and 0.01 from one generator's
    seed; the forward through ``in_relu_ad`` (the dropout folded into K4)
    and ``avg_pool_ad`` equals the one through the library's
    ``instance_norm`` and ``global_avg_pool`` with the eager dropout to
    the bit."""
    model = MICA(base=base, dtype=torch.bfloat16, remat=remat).init_weights(
        torch.Generator().manual_seed(1))
    x, a = _inputs(True, n=2, d=8)

    def forward():
        return model(x, a, train=True, dropout_rate=rate,
                     generator=torch.Generator().manual_seed(2))

    got = forward()
    monkeypatch.setattr(mica, "in_relu", library_in_relu)
    monkeypatch.setattr(mica, "avg_pool", lambda t, *route: mica.global_avg_pool(t))
    want = forward()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.requires_grad and torch.equal(g, w)
