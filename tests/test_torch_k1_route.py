"""The model's route site by site: K1 where its width rule takes the site,
the library formulation in the compute dtype where it does not, on the CPU.

K1 takes 1-3 parts with every Ci and Co a multiple of 32 (``k1_takes``, the
rule ``k1_plan`` raises on).  At base 16 it refuses 8 of a forward's 13
sites (stage 0's RDB and transition, stage 1's RDB, the heads' conv1), at
base 32 3, at base 64 none; the JAX package's shape gate sends such sites
to XLA's conv in the same way.  The wrappers are recorded by patching the
names the model calls; each still runs its plain version.  The bf16 model
at base 16 then matches the f32 one within the card's bf16 gates: the
probabilities within 0.1, and a ``Trainer`` step's gradient at a
whole-vector cosine of 0.85 (``GRAD_FRESH_MIN`` of
``tests/test_torch_cuda_paths.py``).
Its per-tensor gate of 0.7 is a base-64 reading: at base 16 a few small
tensors (the stem's biases) fall below it on either route.
"""

import numpy as np
import pytest
import torch

from mica_tpu_torch.infer.engine import postprocess_logits
from mica_tpu_torch.models import mica
from mica_tpu_torch.models.mica import MICA
from mica_tpu_torch.ops.conv3d_in import k1_plan, k1_sites, k1_takes
from mica_tpu_torch.train.trainer import Trainer


@pytest.mark.parametrize("base,taken", [(16, 5), (32, 10), (64, 13)])
def test_k1_takes_is_k1_plans_rule(base, taken):
    sites = k1_sites(base)
    for cis, co, _ in sites:
        try:
            k1_plan(cis, co, (2, 8, 8, 8))
            planned = True
        except ValueError:
            planned = False
        assert k1_takes(cis, co) is planned, (cis, co)
        if planned:
            # the dx conv of a site K1 takes: Co in, sum Ci out
            assert k1_takes([co], sum(cis))
    assert sum(k1_takes(cis, co) for cis, co, _ in sites) == taken


@pytest.fixture
def sites(monkeypatch):
    """(route, parts' channels, Co) of every RDB, transition and heads
    conv1 the model reaches, in order."""
    seen = []

    def record(route, fn, heads=False):
        def wrapper(parts, weight, *a, **k):
            parts = list(parts) if isinstance(parts, (list, tuple)) else [parts]
            if not heads or weight.shape[0] == 192:
                seen.append((route, [p.shape[-1] for p in parts], weight.shape[0]))
            return fn(parts if len(parts) > 1 or not heads else parts[0], weight, *a, **k)
        return wrapper

    for name in ("conv3d_in_relu", "conv3d_in_relu_ad"):
        monkeypatch.setattr(mica, name, record("k1", getattr(mica, name)))
    monkeypatch.setattr(mica, "conv_in_relu_library",
                        record("library", mica.conv_in_relu_library))
    monkeypatch.setattr(mica, "conv3d", record("k1", mica.conv3d, heads=True))
    monkeypatch.setattr(mica, "conv_same", record("library", mica.conv_same, heads=True))
    return seen


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("base", [16, 32, 64])
def test_sites_go_to_k1_exactly_where_it_takes_them(sites, base, train):
    model = MICA(base=base, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.random((1, 4, 4, 4, 1)).astype(np.float32))
    af = torch.from_numpy((r.random((1, 4, 4, 4, 24)) < 0.1).astype(np.float32))
    with torch.set_grad_enabled(train):
        model(x, af, train=train)
    want = []
    for cis, co, stats in k1_sites(base):
        # the heads' conv1 (no statistics) is a library conv under training,
        # as in the JAX package, and takes the parts' concat there
        k1 = k1_takes(cis, co) and (stats or not train)
        want.append(("k1" if k1 else "library", cis if k1 or stats else [sum(cis)], co))
    assert sites == want


def test_f32_takes_the_library_at_every_site(sites):
    model = MICA(base=64, dtype=torch.float32).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(torch.rand(1, 4, 4, 4, 1), None)
    assert [s[0] for s in sites] == ["library"] * 13


def _batch(seed=3, n=2, d=16):
    r = np.random.default_rng(seed)
    af = (r.random((n, 24, d, d, d)) < 0.03).astype(np.float32)
    af[0] = 0.0
    return (r.random((n, d, d, d)).astype(np.float32), af,
            *(r.integers(0, k, (n, d, d, d)).astype(np.int32) for k in (4, 4, 21)))


def test_bf16_forward_at_base16_matches_f32():
    sd = MICA(base=16, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    density, af3 = _batch()[:2]
    x = torch.from_numpy(density)[..., None]
    af = torch.from_numpy(af3).movedim(1, -1)
    probs = []
    for dt in (torch.bfloat16, torch.float32):
        model = MICA(base=16, dtype=dt)
        model.load_state_dict(sd)
        with torch.no_grad():
            probs.append(postprocess_logits(*model(x, af)))
    for got, want in zip(*probs):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 0.1


def test_bf16_training_step_at_base16_matches_f32():
    """One ``Trainer`` step from the same weights on the same batch
    (augmentation, blanking and dropout off): the losses agree to 1 % and
    the gradients at a whole-vector cosine of 0.85."""
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        tr = Trainer(base_filters=16, dtype=dt, exp_only_prob=0.0, use_augmentation=False,
                     seed=5, device="cpu")
        state = tr.init_state()
        met = tr.train_step(state, _batch(), (1.0, 1.0, 1.0), 0.0)
        got[dt] = (float(met["total_loss"]),
                   torch.cat([p.grad.double().ravel() for p in tr.model.parameters()]))
    (lb, gb), (lf, gf) = got[torch.bfloat16], got[torch.float32]
    assert np.isfinite(lb) and abs(lb - lf) <= 0.01 * abs(lf)
    assert torch.nn.functional.cosine_similarity(gb, gf, dim=0).item() >= 0.85
