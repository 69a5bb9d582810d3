"""The model's route by compute dtype, on the CPU.

The hand-written kernels serve bf16; f32 takes the library formulations the
JAX package's f32 takes (its depthwise kernel is gated on
``self.dtype == jnp.bfloat16`` and its fused conv kernel refuses non-bf16),
with TF32 off over the forward and a training step's backward.  The rule
depends on the dtype alone, so these CPU runs show the route the card
takes: every kernel wrapper (K1/K2, K3, K8 and the training passes) is
counted here by patching the names the model calls.  The CLIs run on the
card by default in f32 too.  That the f32 route agrees with the JAX
package's f32 is shown by the model, engine and training parity tests.
"""

import numpy as np
import pytest
import torch

from mica_tpu_torch.cli import predict as cli_predict
from mica_tpu_torch.cli import run as cli_run
from mica_tpu_torch.cli import train as cli_train
from mica_tpu_torch.models import mica
from mica_tpu_torch.models.mica import MICA, exact_f32, kernel_route
from mica_tpu_torch.train import trainer as trainer_mod

BASE = 16
KERNEL_NAMES = ("conv3d", "conv3d_in_relu", "conv3d_in_relu_ad", "depthwise_conv3_ad")


@pytest.fixture
def calls(monkeypatch):
    """Counts of the kernel wrappers the model reaches, by name; each still
    runs (its plain version, on the CPU)."""
    counts = {}

    def counted(name, fn):
        def wrapper(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return wrapper

    for name in KERNEL_NAMES:
        monkeypatch.setattr(mica, name, counted(name, getattr(mica, name)))
    monkeypatch.setattr(mica.stem_ops, "stem_conv",
                        counted("stem_conv", mica.stem_ops.stem_conv))
    return counts


def _inputs(d=8, seed=0):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.random((2, d, d, d, 1)).astype(np.float32))
    af = torch.from_numpy((r.random((2, d, d, d, 24)) < 0.05).astype(np.float32))
    return x, af


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, True), (torch.float32, False),
                                        (torch.float16, False)])
def test_routing_rule_is_the_dtype_alone(dtype, want):
    assert kernel_route(dtype) is want


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_takes_the_kernels_in_bf16_and_the_library_in_f32(calls, dtype, train):
    model = MICA(base=BASE, dtype=dtype).init_weights(torch.Generator().manual_seed(0))
    x, af = _inputs()
    with torch.set_grad_enabled(train):
        outs = model(x, af, train=train)
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    if dtype == torch.float32:
        assert calls == {}
    elif train:
        # the 5 RDB/transition sites whose widths K1 takes at base 16
        # (``k1_takes``), 3 depthwise; the heads' conv1 and the stem are
        # library convs under training, as in the JAX package
        assert calls == {"conv3d_in_relu_ad": 5, "depthwise_conv3_ad": 3}
    else:
        # K1 refuses the heads' three 16-channel parts at base 16
        assert calls == {"conv3d_in_relu": 5, "depthwise_conv3_ad": 3, "stem_conv": 1}


def test_exact_f32_turns_tf32_off_and_restores_it():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with exact_f32(torch.float32):
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        with exact_f32(torch.bfloat16):
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def test_f32_forward_and_training_backward_run_with_tf32_off(monkeypatch):
    """Every library conv of an f32 forward sees cuDNN's TF32 off, and so
    does the backward of an f32 ``Trainer`` step (its recomputation
    included), though the flag is on around them."""
    seen = []
    conv3d = mica.F.conv3d

    def recording_conv3d(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv3d(*a, **k)

    monkeypatch.setattr(mica.F, "conv3d", recording_conv3d)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        model = MICA(base=BASE, dtype=torch.float32).init_weights(
            torch.Generator().manual_seed(0))
        x, af = _inputs()
        with torch.no_grad():
            model(x, af)
        assert seen and not any(seen)

        in_backward = []
        loss_fn = trainer_mod.multi_task_loss

        def recording_loss(outs, *a, **k):
            for o in outs:
                o.register_hook(lambda g: in_backward.append(torch.backends.cudnn.allow_tf32))
            return loss_fn(outs, *a, **k)

        monkeypatch.setattr(trainer_mod, "multi_task_loss", recording_loss)
        seen.clear()
        tr = trainer_mod.Trainer(base_filters=BASE, dtype=torch.float32, device="cpu", seed=1,
                                 use_augmentation=False)
        state = tr.init_state()
        r = np.random.default_rng(3)
        batch = (r.random((2, 8, 8, 8)).astype(np.float32),
                 (r.random((2, 24, 8, 8, 8)) < 0.05).astype(np.float32),
                 *(r.integers(0, k, (2, 8, 8, 8)) for k in (4, 4, 21)))
        met = tr.train_step(state, batch, (1.0, 1.0, 1.0), 0.0)
        assert np.isfinite(float(met["total_loss"]))
        assert in_backward and not any(in_backward)
        assert seen and not any(seen)      # recomputed convs included
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("cli,argv,flag", [
    (cli_predict, ["-m", "map.mrc", "-o", "out", "--float32"], "float32"),
    (cli_run, ["-m", "map.mrc", "-f", "seq.fasta", "-i", "in", "--float32"], "float32"),
    (cli_train, ["--data_path", "grids.npz", "--dtype", "float32"], "dtype"),
])
def test_clis_run_f32_on_the_card_by_default(cli, argv, flag):
    parser = cli.build_parser()
    args = parser.parse_args(argv)
    assert args.device == "cuda"
    assert getattr(args, flag) in (True, "float32")
    help_text = parser.format_help()
    assert "CPU only" not in help_text and "on the CPU only" not in help_text
