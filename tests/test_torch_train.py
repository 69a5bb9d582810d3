"""The port's training path against the JAX package, on the CPU in f32.

Both sides get the same numpy inputs; weights go through
``state_dict_from_jax_params``.  Tolerances:

  * loss pieces, lambdas, denominators, adaptive clipping: rtol 1e-6
    (the same f32 formulas);
  * augmentation's spatial helpers: exact (they move values);
  * model value_and_grad at base 16, 2 x 16^3, dropout 0: loss rtol 1e-4;
    per tensor cosine > 0.999 and relative L2 < 1e-2, or < 5e-2 for
    tensors below 0.1 of the largest gradient norm.  Both sides are f32,
    and the InstanceNorms amplify conv reassociation in gradients that are
    sums of cancelling terms: against the same network in float64, the
    JAX package's own f32 gradients are off by up to 2 % on such tensors
    (stem biases) and the port's by up to 1.5 %, both at most 0.6 % on
    tensors above 0.1 of the largest norm.  Tensors whose reference
    gradient is below 1e-4 of the largest norm (biases feeding an
    InstanceNorm, mathematically zero) must be as small in the port;
    those the port routes through its fused conv are exactly 0;
  * the port's custom backward against PyTorch's autograd of the same
    forward through the plain versions: relative L2 1e-4 per tensor;
  * microbatch accumulation: gradients rtol 1e-4 / atol 1e-6 of the
    largest full-batch gradient (sums in another order);
  * recomputation with dropout, a resumed step, and steps fed the
    loader's stored types against the same batches widened on the host:
    bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mica_tpu.models.init import init_params_fast
from mica_tpu.models.mica import MICA as JaxMICA
from mica_tpu.models.mica import dropout_rate_for_epoch as jax_dropout_rate
from mica_tpu.train import augment as jaug
from mica_tpu.train import data as jdata
from mica_tpu.train import loss as jloss
from mica_tpu.train.trainer import PlateauScheduler as JaxPlateau
from mica_tpu.train.trainer import adaptive_clip as jax_adaptive_clip
from mica_tpu_torch.models import mica as mica_mod
from mica_tpu_torch.models.convert import state_dict_from_jax_params
from mica_tpu_torch.models.mica import MICA, Dropout, dropout_rate_for_epoch
from mica_tpu_torch.parallel.mesh import Mesh
from mica_tpu_torch.train import augment, data, loss
from mica_tpu_torch.train.trainer import (BATCH_DTYPES, GRAD_HISTORY, PlateauScheduler,
                                          Trainer, adaptive_clip, load_checkpoint,
                                          save_checkpoint)
from mica_tpu_torch.utils import spans

BASE = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# loss, schedules, clipping
# ---------------------------------------------------------------------------


def test_class_weights_and_schedules_match_jax():
    assert loss.CLASS_WEIGHTS == (jloss.BACKBONE_CLASS_WEIGHTS,
                                  jloss.CARBON_ALPHA_CLASS_WEIGHTS,
                                  jloss.AMINO_ACID_CLASS_WEIGHTS)
    for epoch in (0, 1, 5, 12.5, 24, 25, 60):
        np.testing.assert_allclose(loss.task_lambdas(epoch), jloss.task_lambdas(epoch),
                                   rtol=1e-12)
        assert dropout_rate_for_epoch(int(epoch)) == jax_dropout_rate(int(epoch))


@pytest.mark.parametrize("smoothing,with_denoms", [(0.0, False), (0.1, False), (0.0, True)])
def test_multi_task_loss_matches_jax(rng, smoothing, with_denoms):
    outs = [rng.normal(size=(2, 5, 4, 3, c)).astype(np.float32) for c in (4, 4, 21)]
    tgts = [rng.integers(0, c, (2, 5, 4, 3)).astype(np.int32) for c in (4, 4, 21)]
    lam = jloss.task_lambdas(7)
    jd = jloss.class_weight_denominators(tuple(jnp.asarray(t) for t in tgts))
    td = loss.class_weight_denominators(tuple(_t(t) for t in tgts))
    np.testing.assert_allclose([float(v) for v in td], [float(v) for v in jd], rtol=1e-6)
    total_j, met_j = jloss.multi_task_loss(tuple(jnp.asarray(o) for o in outs),
                                           tuple(jnp.asarray(t) for t in tgts),
                                           jnp.asarray(lam), smoothing,
                                           denominators=jd if with_denoms else None)
    total_t, met_t = loss.multi_task_loss(tuple(_t(o) for o in outs), tuple(_t(t) for t in tgts),
                                          lam, smoothing, td if with_denoms else None)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-6)
    assert met_t.keys() == met_j.keys()
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]), rtol=1e-6, err_msg=k)


def test_adaptive_clip_matches_jax(rng):
    """A run of 14 steps with two spikes: ring buffer, count, norm, clip
    decision and the scaled gradients agree at every step."""
    norms_j = jnp.zeros((GRAD_HISTORY,), jnp.float32)
    count_j = jnp.zeros((), jnp.int32)
    norms_t = torch.zeros(GRAD_HISTORY)
    count_t = torch.zeros((), dtype=torch.int64)
    seen_clip = False
    for step in range(14):
        scale = 30.0 if step in (6, 11) else 1.0
        g = {"a": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
             "b": (rng.normal(size=(5,)) * scale).astype(np.float32)}
        gj, norms_j, count_j, nj, cj = jax_adaptive_clip(
            {k: jnp.asarray(v) for k, v in g.items()}, norms_j, count_j)
        gt, norms_t, count_t, nt, ct = adaptive_clip([_t(g["a"]), _t(g["b"])], norms_t, count_t)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        assert bool(ct) == bool(cj) and int(count_t) == int(count_j)
        np.testing.assert_allclose(norms_t.numpy(), np.asarray(norms_j), rtol=1e-6)
        for a, k in zip(gt, ("a", "b")):
            np.testing.assert_allclose(a.numpy(), np.asarray(gj[k]), rtol=1e-6)
        seen_clip |= bool(ct)
    assert seen_clip


def test_plateau_scheduler_matches_jax(rng):
    ours, ref = PlateauScheduler(lr=1e-4, patience=2), JaxPlateau(lr=1e-4, patience=2)
    metrics = [1.0, 0.9, 0.9, 0.9, 0.9, 0.9] + list(rng.random(30))
    for m in metrics:
        assert ours.step(m) == ref.step(m)
    assert ours.state_dict() == ref.state_dict()
    s = PlateauScheduler(lr=1e-4, patience=2)
    lrs = [s.step(m) for m in [1.0, 0.9, 0.9, 0.9, 0.9, 0.9]]
    assert lrs[-1] == pytest.approx(5e-5)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_data_helpers_match_jax(tmp_path):
    for a, b in zip(data.synthetic_batch(2, 6, seed=3), jdata.synthetic_batch(2, 6, seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(data.train_val_split(37, 0.3, 5), jdata.train_val_split(37, 0.3, 5)):
        np.testing.assert_array_equal(a, b)
    ds = data.ArrayDataset(*data.synthetic_batch(5, 4, seed=1))
    ds.save(str(tmp_path / "d.npz"))
    back = data.ArrayDataset.load(str(tmp_path / "d.npz"))
    jds = jdata.ArrayDataset.load(str(tmp_path / "d.npz"))
    ours = list(data.batch_iterator(back, 2, seed=4, drop_last=False))
    ref = list(jdata.batch_iterator(jds, 2, seed=4, drop_last=False))
    assert len(ours) == len(ref) == 3
    for bo, br in zip(ours, ref):
        for a, b in zip(bo, br):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# augmentation and dropout
# ---------------------------------------------------------------------------


def test_spatial_helpers_match_jax(rng):
    x = rng.normal(size=(3, 5, 5, 5)).astype(np.float32)  # cubic: lax.switch's branches
    for v in range(9):
        np.testing.assert_array_equal(augment.rot90_variant(_t(x), v).numpy(),
                                      np.asarray(jaug._rot90_variants(jnp.asarray(x), v)))
    for a in range(3):
        np.testing.assert_array_equal(augment.flip_variant(_t(x), a).numpy(),
                                      np.asarray(jaug._flip_variants(jnp.asarray(x), a)))
    for sigma in (0.5, 0.77, 1.0):
        np.testing.assert_allclose(augment.blur3(_t(x), sigma).numpy(),
                                   np.asarray(jaug._blur3(jnp.asarray(x), jnp.float32(sigma))),
                                   rtol=1e-5, atol=1e-6)


def test_augment_joint_spatial_consistency(rng):
    """AF3 channels that copy a target mask follow it through every
    spatial transform (rot90, flip, roll), as in the JAX package's test."""
    d = 8
    tgt = rng.integers(0, 4, (6, 3, d, d, d)).astype(np.int64)
    af3 = np.repeat(tgt[:, :1].astype(np.float32), 24, axis=1)
    density = np.zeros((6, 1, d, d, d), np.float32)
    gen = torch.Generator().manual_seed(0)
    changed = 0
    for _ in range(4):
        dens_o, af_o, tgt_o = augment.augment_batch(gen, _t(density), _t(af3), _t(tgt))
        assert dens_o.shape == density.shape and tgt_o.dtype == torch.int64
        assert torch.equal(af_o[:, 0].long(), tgt_o[:, 0])
        assert torch.equal(af_o[:, 5].long(), tgt_o[:, 0])
        changed += int((tgt_o != _t(tgt)).any(dim=(1, 2, 3, 4)).sum())
    assert changed > 0, "no spatial augmentation fired in 24 samples"


def test_augment_gate_rate():
    """The gate fires with p = 0.4: the share of samples whose density
    changes is 0.4 x P(some density op) within 4 sigma."""
    n = 2000
    gen = torch.Generator().manual_seed(1)
    density = torch.rand(n, 1, 2, 2, 2, generator=torch.Generator().manual_seed(2))
    out, _, _ = augment.augment_batch(gen, density, torch.zeros(n, 24, 2, 2, 2),
                                      torch.zeros(n, 3, 2, 2, 2, dtype=torch.int64))
    frac = (out != density).any(dim=(1, 2, 3, 4)).float().mean().item()
    # a density op fires unless noise, brightness, contrast, spatial-roll
    # and blur all stay off; the spatial block moves values too
    p_none = (1 - 0.7) * (1 - 0.5) * (1 - 0.5) * (1 - 0.2) * (
        1 - 0.6 * (1 - (1 - 0.5) * (1 - 0.3) * (1 - 0.4)))
    want = 0.4 * (1 - p_none)
    assert abs(frac - want) < 4 * np.sqrt(want * (1 - want) / n), (frac, want)


@pytest.mark.parametrize("rate", [0.02, 0.2])
def test_dropout_statistics(rate):
    """Channel dropout keeps a whole (sample, channel) with p = 1 - rate
    and scales it by 1 / (1 - rate); elementwise dropout per element."""
    x = torch.ones(64, 3, 3, 3, 256)
    y = Dropout(5).channels(x, rate)
    per_channel = y[:, :, :, :, :].reshape(64, 27, 256)
    assert torch.equal(per_channel.amin(dim=1), per_channel.amax(dim=1))
    kept = (per_channel[:, 0] != 0).float()
    n = kept.numel()
    assert abs(kept.mean().item() - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n)
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - rate)))
    e = Dropout(6).elements(torch.ones(512, 300), rate)
    assert abs((e != 0).float().mean().item() - (1 - rate)) < 4 * np.sqrt(
        rate * (1 - rate) / e.numel())
    assert torch.equal(Dropout(7).channels(x, rate), Dropout(7).channels(x, rate))


@pytest.mark.parametrize("rate", [0.005, 0.01, 0.02, 0.1])
def test_dropout_scales_kept_values_as_flax_in_bf16(rng, rate):
    """Kept bf16 values equal flax's ``x / keep_prob`` on the same bf16
    values bitwise; dropped ones are 0."""
    x = rng.normal(size=(4, 3, 3, 3, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = torch.from_numpy(np.asarray(
        (jnp.asarray(x, jnp.bfloat16) / (1.0 - rate)).astype(jnp.float32)))
    for y in (Dropout(3).channels(xb, rate), Dropout(4).elements(xb, rate)):
        assert y.dtype == torch.bfloat16
        kept = y != 0
        assert kept.any()
        assert torch.equal(y.float()[kept], want[kept])


# ---------------------------------------------------------------------------
# the model's gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return init_params_fast(JaxMICA(base=BASE),
                            (jnp.zeros((1, 8, 8, 8, 1)), jnp.zeros((1, 8, 8, 8, 24))), seed=5)


def _grad_inputs(n=2, d=16, seed=11):
    r = np.random.default_rng(seed)
    x = r.random((n, d, d, d, 1)).astype(np.float32)
    af = (r.random((n, d, d, d, 24)) < 0.03).astype(np.float32)
    af[0] = 0.0  # sample 0 takes the density-only stem branch
    tgt = tuple(r.integers(0, c, (n, d, d, d)).astype(np.int32) for c in (4, 4, 21))
    return x, af, tgt


@pytest.fixture(scope="module")
def jax_value_and_grad(jax_params):
    x, af, tgt = _grad_inputs()
    lam = jloss.task_lambdas(3)

    def loss_j(p):
        outs = JaxMICA(base=BASE).apply({"params": p}, jnp.asarray(x), jnp.asarray(af),
                                        dropout_rate=0.0, train=True,
                                        rngs={"dropout": jax.random.PRNGKey(0)})
        return jloss.multi_task_loss(outs, tuple(jnp.asarray(t) for t in tgt),
                                     jnp.asarray(lam))[0]

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss_j))(jax_params)
    ref = {k: v.numpy().astype(np.float64) for k, v in state_dict_from_jax_params(g_ref).items()}
    return float(l_ref), ref


@pytest.mark.parametrize("route", ["kernels", "library"])
def test_model_value_and_grad_matches_jax(jax_params, jax_value_and_grad, route, monkeypatch):
    """Both routes of the f32 model against the JAX package's f32 value and
    gradient: the kernel route (forced here; bf16 takes it), whose custom
    backward gives the fused convs' biases a gradient of exactly 0, and
    the library route that f32 takes (``kernel_route``), whose autograd
    gives them noise, as JAX's does.  Forcing the kernel route forces it at
    every site, whatever K1's width rule (``k1_takes``) says on the card."""
    if route == "kernels":
        monkeypatch.setattr(mica_mod, "kernel_route", lambda dtype: True)
        monkeypatch.setattr(mica_mod, "k1_takes", lambda cis, co: True)
    x, af, tgt = _grad_inputs()
    lam = jloss.task_lambdas(3)
    l_ref, ref = jax_value_and_grad

    model = MICA(base=BASE, dtype=torch.float32, remat=True)
    model.load_state_dict(state_dict_from_jax_params(jax_params), strict=True)
    outs = model(_t(x), _t(af), train=True)
    l_got, _ = loss.multi_task_loss(outs, tuple(_t(t) for t in tgt), lam)
    l_got.backward()
    got = {k: p.grad.numpy().astype(np.float64) for k, p in model.named_parameters()}

    np.testing.assert_allclose(l_got.item(), l_ref, rtol=1e-4)
    assert got.keys() == ref.keys()
    gmax = max(np.linalg.norm(v) for v in ref.values())
    fused_biases = [k for k in got if k.endswith(".bias") and (
        ".conv1.0." in k or ".conv2.0." in k or ".conv3.0." in k or ".transition." in k)]
    assert len(fused_biases) == 12
    for k in fused_biases:
        assert (not got[k].any()) == (route == "kernels"), k
    n_compared = 0
    for k, r in ref.items():
        a, nr = got[k].ravel(), np.linalg.norm(r)
        if nr < 1e-4 * gmax:
            assert np.linalg.norm(a) < 1e-3 * gmax, (k, np.linalg.norm(a), gmax)
            continue
        cos = float(a @ r.ravel() / (np.linalg.norm(a) * nr))
        rel = float(np.linalg.norm(a - r.ravel()) / nr)
        rel_tol = 1e-2 if nr >= 0.1 * gmax else 5e-2
        assert cos > 0.999 and rel < rel_tol, (k, cos, rel)
        n_compared += 1
    assert n_compared > 90


def _cosines(got, ref):
    """Whole-vector cosine and the median per-tensor cosine over the
    tensors above 1e-4 of the largest reference norm."""
    a = np.concatenate([got[k] for k in ref])
    r = np.concatenate(list(ref.values()))
    gmax = max(np.linalg.norm(v) for v in ref.values())
    per = [float(got[k] @ v / (np.linalg.norm(got[k]) * np.linalg.norm(v)))
           for k, v in ref.items() if np.linalg.norm(v) >= 1e-4 * gmax]
    return float(a @ r / (np.linalg.norm(a) * np.linalg.norm(r))), float(np.median(per))


def test_bf16_gradient_no_farther_from_f32_than_jax(jax_params):
    """bf16 rounding alone moves a gradient at fresh weights far from the
    f32 one (whole-vector cosine ~0.85-0.9 at 2 x 16^3).  The port's bf16
    gradient is at least as close to its f32 gradient as the JAX package's
    bf16 gradient is to its own, whole and per tensor (median)."""
    x, af, tgt = _grad_inputs()
    lam = jloss.task_lambdas(0)
    grads = {}
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        def loss_j(p):
            outs = JaxMICA(base=BASE, dtype=jdt).apply(
                {"params": p}, jnp.asarray(x), jnp.asarray(af), dropout_rate=0.0, train=True,
                rngs={"dropout": jax.random.PRNGKey(0)})
            return jloss.multi_task_loss(outs, tuple(jnp.asarray(t) for t in tgt),
                                         jnp.asarray(lam))[0]

        g = jax.jit(jax.grad(loss_j))(jax_params)
        grads["jax", dt] = {k: v.numpy().astype(np.float64).ravel()
                            for k, v in state_dict_from_jax_params(g).items()}
        model = MICA(base=BASE, dtype=dt)
        model.load_state_dict(state_dict_from_jax_params(jax_params), strict=True)
        loss.multi_task_loss(model(_t(x), _t(af), train=True), tuple(_t(t) for t in tgt),
                             lam)[0].backward()
        grads["port", dt] = {k: p.grad.numpy().astype(np.float64).ravel()
                             for k, p in model.named_parameters()}
    ours = _cosines(grads["port", torch.bfloat16], grads["port", torch.float32])
    ref = _cosines(grads["jax", torch.bfloat16], grads["jax", torch.float32])
    assert ours[0] >= ref[0] and ours[1] >= ref[1], (ours, ref)


def test_custom_backward_matches_autograd_of_the_plain_forward(monkeypatch):
    """On the CPU the inference forward is plain PyTorch (K1/K2/K3's and
    ``in_sums``'s plain versions), so autograd differentiates it
    independently of the custom backward (``Conv3dInReluFn``,
    ``InReluFn``, ``AvgPoolFn`` and K3's: K4-K7's plain versions, the dx
    conv, db = 0, g / n) that ``train=True`` takes: every gradient agrees to 1e-4 relative L2
    (measured 6e-6; the stem's and heads' training-mode casts are
    identities in f32).  The kernel route is forced, since f32 takes the
    library route by default (``kernel_route``), at every site, whatever
    K1's width rule (``k1_takes``) says on the card.  The stem has no custom
    backward and takes its training route in both runs: its inference
    route sums the same conv in another order, and the network's gradients
    carry that rounding to 1e-3, which is not what this test is about."""
    monkeypatch.setattr(mica_mod, "kernel_route", lambda dtype: True)
    monkeypatch.setattr(mica_mod, "k1_takes", lambda cis, co: True)
    x, af, tgt = _grad_inputs(seed=12)
    lam = loss.task_lambdas(0)
    model = MICA(base=BASE, dtype=torch.float32).init_weights(torch.Generator().manual_seed(3))
    stem = model.input_processing.stem
    model.input_processing.stem = lambda x, train=False, kernels=True: stem(x, True, kernels)
    grads = []
    for train in (True, False):
        model.zero_grad(set_to_none=True)
        outs = model(_t(x), _t(af), train=train)
        loss.multi_task_loss(outs, tuple(_t(t) for t in tgt), lam)[0].backward()
        grads.append({k: p.grad.double() for k, p in model.named_parameters()})
    custom, auto = grads
    gmax = max(v.norm() for v in auto.values())
    for k, r in auto.items():
        err = (custom[k] - r).norm()
        assert err <= 1e-4 * max(r.norm(), 1e-2 * gmax), (k, float(err), float(r.norm()))


def test_recomputation_with_dropout_gives_identical_gradients():
    """Checkpointed blocks redraw their dropout masks from their seeds: the
    gradients equal the plain run's bit for bit at a dropout rate of 0.2."""
    x, af, _ = _grad_inputs(d=8)
    grads = []
    for remat in (True, False):
        model = MICA(base=BASE, dtype=torch.float32, remat=remat).init_weights(
            torch.Generator().manual_seed(0))
        outs = model(_t(x), _t(af), dropout_rate=0.2, train=True,
                     generator=torch.Generator().manual_seed(9))
        sum((o * o).sum() for o in outs).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    assert any(torch.count_nonzero(v) for v in grads[0].values())


def test_dropout_changes_the_forward():
    x, af, _ = _grad_inputs(d=8)
    model = MICA(base=BASE, dtype=torch.float32).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = model(_t(x), _t(af), train=True)
        dropped = model(_t(x), _t(af), dropout_rate=0.2, train=True,
                        generator=torch.Generator().manual_seed(1))
        again = model(_t(x), _t(af), dropout_rate=0.2, train=True,
                      generator=torch.Generator().manual_seed(1))
    assert not torch.equal(plain[0], dropped[0])
    assert all(torch.equal(a, b) for a, b in zip(dropped, again))
    with pytest.raises(ValueError, match="generator"):
        model(_t(x), _t(af), dropout_rate=0.2, train=True)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _skewed_batch(n=4, d=8, seed=0):
    """Per-microbatch class-weight sums that differ by orders of magnitude,
    so per-microbatch normalisation would be visibly wrong."""
    density, af3, bb, ca, aa = data.synthetic_batch(n, d, seed)
    r = np.random.default_rng(seed + 1)
    half = n // 2
    for t, hi in ((bb, 4), (ca, 4), (aa, 21)):
        t[:half] = (r.random(t[:half].shape) < 0.01) * r.integers(1, hi, t[:half].shape)
        t[half:] = r.integers(hi - 2, hi, t[half:].shape)
    return density, af3, bb, ca, aa


def _trainer(**kw):
    kw = {"base_filters": BASE, "lr": 3e-4, "dtype": torch.float32, "device": "cpu",
          "seed": 7, **kw}
    return Trainer(**kw)


def test_trainer_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(base_filters=BASE)


def test_microbatch_accumulation_matches_full_batch():
    batch = _skewed_batch()
    lam = loss.task_lambdas(0)
    results = []
    for mb in (None, 2):
        tr = _trainer(microbatch=mb, use_augmentation=False, exp_only_prob=0.0)
        st = tr.init_state()
        met = tr.train_step(st, batch, lam, 0.0)
        results.append((met, {k: p.grad.clone() for k, p in tr.model.named_parameters()}))
    (m_full, g_full), (m_mb, g_mb) = results
    for k in ("total_loss", "backbone_loss", "carbon_alpha_loss", "amino_acid_loss",
              "lambda_a", "gradient_norm"):
        np.testing.assert_allclose(float(m_mb[k]), float(m_full[k]), rtol=1e-5, err_msg=k)
    gmax = max(v.abs().max().item() for v in g_full.values())
    for k in g_full:
        torch.testing.assert_close(g_mb[k], g_full[k], rtol=1e-4, atol=1e-6 * gmax)


def test_trainer_lowers_loss_on_a_fixed_batch():
    tr = _trainer(use_augmentation=False, exp_only_prob=0.0)
    st = tr.init_state()
    batch = data.synthetic_batch(4, 8)
    losses = [float(tr.train_step(st, batch, loss.task_lambdas(0), 0.01)["total_loss"])
              for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert st.step == 6 and int(st.grad_count) == 6


def test_checkpoint_resume_takes_the_identical_next_step(tmp_path):
    """save -> load into a fresh trainer -> the next step (augmentation,
    blanking and dropout on) gives the same metrics and weights."""
    batch = data.synthetic_batch(2, 8, seed=2)
    lam = loss.task_lambdas(1)
    tr = _trainer()
    st = tr.init_state()
    for _ in range(2):
        tr.train_step(st, batch, lam, 0.1)
    tr.scheduler.step(1.0)
    save_checkpoint(str(tmp_path / "ck.pt"), tr, st, epoch=3, val_loss=0.5)
    want = tr.train_step(st, batch, lam, 0.1)

    tr2 = _trainer(seed=99)
    st2 = tr2.init_state()
    assert tr2.restore(st2, load_checkpoint(str(tmp_path / "ck.pt"))) == 4
    assert st2.step == 2 and tr2.scheduler.state_dict() == tr.scheduler.state_dict()
    got = tr2.train_step(st2, batch, lam, 0.1)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (k, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(st.grad_norms, st2.grad_norms)


def test_run_epoch_and_validation():
    tr = _trainer()
    st = tr.init_state()
    ds = data.ArrayDataset(*data.synthetic_batch(6, 8, seed=4))
    st, met = tr.run_epoch(st, data.batch_iterator(ds, 2), epoch=0)
    assert met["steps"] == 3 and np.isfinite(met["total_loss"])
    val = tr.run_validation(st, data.batch_iterator(ds, 4, shuffle=False, drop_last=False), 0)
    assert set(val) == {"total_loss", "backbone_loss", "carbon_alpha_loss", "amino_acid_loss"}
    assert all(np.isfinite(v) for v in val.values())


def _packed(n, d, seed):
    """A dataset in the types ``ArrayDataset.save`` packs: f32 density,
    uint8 AF3 bits, int8 labels."""
    density, af3, bb, ca, aa = data.synthetic_batch(n, d, seed)
    return data.ArrayDataset(density, af3.astype(np.uint8), bb.astype(np.int8),
                             ca.astype(np.int8), aa.astype(np.int8))


def _widened(batch):
    """``batch`` widened on the host to the types the step computes on."""
    return tuple(b.astype(t) for b, t in zip(batch, (np.float32, np.float32) + (np.int32,) * 3))


NARROW = (np.float32, np.uint8, np.int8, np.int8, np.int8)


def test_loader_keeps_the_stored_types_and_the_trainer_widens_them():
    ds = _packed(6, 4, seed=3)
    whole = list(data.batch_iterator(ds, 4, seed=2, drop_last=False))
    for batch, idx in zip(whole, np.split(np.random.default_rng(2).permutation(6), [4])):
        assert tuple(b.dtype for b in batch) == NARROW
        for b, f in zip(batch, ("density", "af3", "bb", "ca", "aa")):
            np.testing.assert_array_equal(b, getattr(ds, f)[idx])
    for r in range(2):
        m = Mesh(rank=r, size=2, local_rank=r, device=torch.device("cpu"), distributed=True)
        shard = next(data.batch_iterator(ds, 4, seed=2, mesh=m))
        assert isinstance(shard, data.RowShard) and shard.first == 2 * r
        assert tuple(b.dtype for b in shard.rows) == NARROW
        for a, b in zip(shard.rows, whole[0]):
            np.testing.assert_array_equal(a, b[2 * r:2 * r + 2])

    tr = _trainer()
    spans.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = tr._to_device(whole[0])
        assert spans.counter("h2d_bytes") == sum(b.nbytes for b in whole[0])
        assert spans.counter("h2d_bytes") == 4 * 4 ** 3 * (4 + 24 + 3)
    finally:
        spans.clear()
    assert tuple(t.dtype for t in got) == BATCH_DTYPES
    for t, w in zip(got, _widened(whole[0])):
        assert torch.equal(t, torch.from_numpy(w))
    # a batch already in f32 and int32 comes through as it is
    wide = data.synthetic_batch(2, 4, seed=1)
    for t, w, dt in zip(tr._to_device(wide), wide, BATCH_DTYPES):
        assert t.dtype == dt and torch.equal(t, torch.from_numpy(w))


def test_stored_type_feed_trains_bit_identical_to_the_widened_feed():
    """Augmentation, AF3 blanking and dropout on: three steps and a
    validation pass fed the stored types equal, to the bit, those fed the
    same batches widened on the host."""
    ds = _packed(6, 8, seed=5)
    lam = loss.task_lambdas(1)
    runs = []
    for widen in (False, True):
        tr = _trainer(exp_only_prob=0.5)
        st = tr.init_state()
        mets = []
        for batch in data.batch_iterator(ds, 2, seed=9):
            mets.append(tr.train_step(st, _widened(batch) if widen else batch, lam, 0.1))
        feed = data.batch_iterator(ds, 4, shuffle=False, drop_last=False)
        val = tr.run_validation(st, (_widened(b) if widen else b for b in feed), 1)
        runs.append((tr, st, mets, val))
    (tr, st, mets, val), (tr2, st2, mets2, val2) = runs
    assert len(mets) == st.step == 3
    for m, m2 in zip(mets, mets2):
        assert m.keys() == m2.keys()
        for k in m:
            assert torch.equal(m[k], m2[k]), k
    for (k, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    for p, p2 in zip(tr.model.parameters(), tr2.model.parameters()):
        s, s2 = st.optimizer.state[p], st2.optimizer.state[p2]
        assert s.keys() == s2.keys() and all(torch.equal(s[k], s2[k]) for k in s)
    assert torch.equal(st.grad_norms, st2.grad_norms)
    assert val == val2


def test_cli_train_one_epoch(tmp_path):
    from mica_tpu_torch.cli.train import main

    data.ArrayDataset(*data.synthetic_batch(5, 8, seed=6)).save(str(tmp_path / "d.npz"))
    args = ["--data_path", str(tmp_path / "d.npz"), "--output_path", str(tmp_path / "out"),
            "--batch_size", "2", "--num_epochs", "1", "--base_filters", str(BASE),
            "--dtype", "float32", "--log_dir", str(tmp_path / "logs"), "--device", "cpu"]
    assert main(args) == 0
    ck = sorted((tmp_path / "out").glob("mica_epoch_0*.pt"))
    assert len(ck) == 1
    assert main(args[:7] + ["2"] + args[8:] + ["--resume_train", "--model_checkpoint",
                                                 str(ck[0])]) == 0
    assert len(list((tmp_path / "out").glob("mica_epoch_1*.pt"))) == 1
    assert len(list((tmp_path / "logs").glob("*.metrics.jsonl"))) >= 1
