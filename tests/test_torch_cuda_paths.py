"""The port's paths end to end on the card, at the sizes the port runs.

Marked ``cuda``; each test skips where there is no card, before it builds
any input.  On a machine with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_paths.py

(``-m "cuda and not slow"`` leaves out the learned test, about seven
minutes).  Random weights from ``SEED`` unless a test trains its own.
What each test holds is in its docstring; the limits are the module's
constants.
"""

import copy
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
SEED = 0
BASE, BATCH, WIN = 64, 8, 64          # MICA's published width, the engine's batch and window
MAP = 160                             # voxels an axis of the prediction map: 4 cores of 48
ENGINE = dict(batch_size=BATCH, dtype=torch.bfloat16, base_filters=BASE, core=48, halo=8)
PROBS = ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability")
INFERENCE_ONLY = ("in_apply", "in_sums", "stem9", "gather_windows", "scatter_cores")
# a training step at base 64 with recomputation: K1 12 forward + 9
# recomputed + 12 dx; K3 3 forward + 3 recomputed + 3 dx
TRAIN_PER_STEP = {"conv3d_stats": 33, "in_apply_ad": 21, "in_bwd_stats": 12,
                  "in_bwd_apply": 12, "depthwise3": 9, "depthwise3_grads": 3}
# Limits of the bf16 card gradient against the f32 CPU gradient: (cosine
# of the whole vector, worst cosine of a tensor above 1e-4 of the largest
# reference norm) at weights initialised from the seed, and the whole
# vector's cosine at the trainer's weights.  At fresh weights bf16 itself
# is that far from f32: on the H100, seeds 0-3 read 0.883-0.894 whole and
# 0.769-0.795 worst, and the JAX package's own bf16 gradient is no closer
# to its f32 one (``test_bf16_gradient_no_farther_from_f32_than_jax``).
GRAD_FRESH_MIN = (0.85, 0.7)
GRAD_TRAINED_MIN = 0.9
# f32 on the card against f32 on the CPU: the same formulas, summed in
# another order; the whole gradient's cosine
F32_GRAD_MIN = 0.9999
F32_MAP, F32_CORE = 16, 16            # the f32 test's map (voxels an axis) and window core
F32_KERNELS = ("conv3d_stats", "in_apply", "in_sums", "in_apply_ad", "in_bwd_stats",
               "in_bwd_apply", "depthwise3", "depthwise3_grads", "stem9")
N_RES = 400                           # residues of the modelling scenario's chain
MERIZO_RES = 1000                     # residues of the chain Merizo runs on, card against CPU
MERIZO_TOL = 1e-3                     # card against CPU, mask and background logits (f32, TF32 off)
PREP_CHAINS = {"fold_a": {"A": (260, 260), "B": (80,)},     # residues per domain
               "fold_b": {"A": (150,), "B": (40,)}}
DUMP_MAP = 96                         # voxels an axis of the dumps' map: 8 windows of core 48
# The learned test: the fixture's training (``scripts/train_synth_fixture``:
# base 16, bf16, batch 8, 144^3 scenarios of 170 residues, lr 3e-4) for
# LEARNED_STEPS of its 1200 steps, on LEARNED_SCENARIOS of its 8 scenarios,
# keeping the weights with the best mean validation backbone Dice
# (LEARNED_VAL scenarios, seeds 54321 on, measured every
# LEARNED_SELECT_EVERY steps).  The held-out backbone Dice is that of the
# kept weights, the mean over LEARNED_HELD_OUT 96^3 scenarios (seeds 12345
# on; the JAX script takes the first alone).  The Dice (P > 0.5) of one
# step's weights wanders: on the card it rose from < 0.01 at step 400 to
# 0.08-0.15 at step 600 in four runs of the same code, fell to 0.07-0.09
# over steps 700-900 as the task weights left the backbone, and came back
# to 0.12-0.18 by 1000-1200; the training is not bitwise repeatable
# (cuDNN's backward), so no single step is safe.  The demo runs on the
# last step's weights, as the fixture exports them: on the kept weights
# of two runs (steps 950 and 1100) it covered 0.84 and 0 of the chain, on
# the last step's of five runs 0.98-1.00.
LEARNED_BASE = 16
LEARNED_STEPS = 1200
LEARNED_SCENARIOS = 8
LEARNED_HELD_OUT = 4
LEARNED_VAL = 4
LEARNED_SELECT_EVERY = 50
DICE_GAIN_MIN = 0.1         # held-out backbone Dice over the initial weights'
# the demo's CA coverage (< 3 A) on the learned weights: 1.000 on the
# first card run of this check, 0.990 on the fixture's full run
DEMO_COVERAGE_FLOOR = 0.9
# launches at base 16, where K1 takes 5 of the 13 sites: a training step
# (recomputation on) and an inference forward
LEARNED_PER_STEP = {"conv3d_stats": 13, "in_apply_ad": 8, "in_bwd_stats": 5, "in_bwd_apply": 5,
                    "depthwise3": 9, "depthwise3_grads": 3}
LEARNED_PER_FORWARD = {"conv3d_stats": 5, "in_apply": 14, "in_sums": 19, "depthwise3": 3,
                       "stem9": 1}
# The multi-GPU test, limits set before its first card run.  World 2
# (gloo, both ranks on one card, 4 windows a rank a batch) against world 1
# (8 windows a batch): the probabilities; runs of one batch composition
# are equal to the bit.
MGPU_WORLD2_TOL = 0.05
MGPU_SHARD_BYTES_MAX = 0.55     # the sharded volumes' bytes a rank over the replicated ones'
# the data-parallel f32 step at world 2 against world 1: relative loss,
# cosine of the whole gradient
DP_LOSS_REL = 1e-5
DP_GRAD_COS = 0.9999
DP_KERNELS = ("conv3d_stats", "depthwise3", "in_apply_ad", "in_bwd_stats", "in_bwd_apply",
              "depthwise3_grads")


@pytest.fixture
def card():
    """Skips where there is no card; cuDNN's TF32 on (PyTorch's default)
    and cuBLAS's off in the test, both restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    torch.cuda.empty_cache()


def _model(seed=SEED, **kw):
    from mica_tpu_torch.models.mica import MICA

    return MICA(base=BASE, **kw).init_weights(torch.Generator().manual_seed(seed))


def _predict_launches_ok(launches: dict, timing: dict, batch: int = BATCH) -> None:
    """One ``predict_volume`` run in core blend with the AF3 words at base
    64: K1/K2/K3/K8/``in_sums`` 13/21/3/1/19 a forward (K2 after 12 K1
    sites and 9 ``in_sums`` ones; ``in_sums`` at those 9 norms and 10
    pools), K9 and K10 one a computed batch (the all-zero window's forward
    needs neither), nothing else."""
    fw = timing["n_forwards"]
    computed = timing["n_windows"] - timing["n_empty"]
    batches = -(-computed // batch)
    assert fw == batches + 1, f"{fw} forwards for {batches} batches and the all-zero window"
    want = {"conv3d_stats": 13 * fw, "in_apply": 21 * fw, "in_sums": 19 * fw,
            "depthwise3": 3 * fw, "stem9": fw, "gather_windows": batches,
            "scatter_cores": batches}
    assert launches == {k: want.get(k, 0) for k in launches}, (launches, fw, batches)


def _volumes_ok(vols: dict, n: int) -> None:
    """bb and ca of the map's shape, finite, in [0, 1]; aa (20, ...),
    finite, summing to 1 within 1e-4 (numpy or card tensors)."""
    vols = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in vols.items()}
    for key in PROBS[:2]:
        v = vols[key]
        assert v.shape == (n, n, n), (key, v.shape)
        assert np.isfinite(v).all(), key
        assert v.min() >= 0 and v.max() <= 1, key
    aa = vols["amino_acid_probability"]
    assert aa.shape == (20, n, n, n) and np.isfinite(aa).all()
    assert np.abs(aa.sum(axis=0) - 1.0).max() <= 1e-4


def test_predict_map_at_base_64(card, tmp_path):
    """``predict_map`` as the CLI runs it (bf16, batch 8, core 48, halo 8,
    the AF3 words of a docked model) on a 160^3 map: the volumes and the
    launch counts of ``_predict_launches_ok``."""
    from mica_tpu_torch.infer.pipeline import predict_map

    map_path, pdb_path = ranks.card_map(tmp_path, MAP, SEED)
    before = ranks.launch_counts()
    out = predict_map(str(map_path), _model(), docked_pdb_path=str(pdb_path), **ENGINE)
    _predict_launches_ok(ranks.launched_since(before), out["timing"])
    _volumes_ok(out, MAP)


def test_base_64_bf16_windows_stay_near_the_f32_cpu(card):
    """2 x 16^3 windows (the first without AF3) through the card's bf16
    kernels at base 64: probabilities within 0.1 of the same weights in
    f32 on the CPU."""
    from mica_tpu_torch.infer.engine import postprocess_logits

    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.random((2, 16, 16, 16, 1)).astype(np.float32))
    af = torch.from_numpy((rng.random((2, 16, 16, 16, 24)) < 0.03).astype(np.float32))
    af[0] = 0.0
    model = _model()
    cpu = copy.deepcopy(model).float()
    cpu.dtype = torch.float32
    model.cuda()
    model.dtype = torch.bfloat16
    with torch.no_grad():
        want = postprocess_logits(*cpu(x, af))
        got = postprocess_logits(*model(x.cuda(), af.cuda()))
    errs = [(g.cpu() - w).abs().max().item() for g, w in zip(got, want)]
    assert max(errs) <= 0.1, errs


def _all_atom_ok(pdb_io, sol, placed) -> None:
    """The all-atom model ``Solver.run`` wrote from the CA model: a residue
    for each placed CA, each with N, CA, C and O and as many heavy atoms
    as its type has, every coordinate finite; PHENIX's command made."""
    from benchmark.gen import SIDE_CHAIN

    path = Path(sol.ca_model_path.replace("_ca_model.pdb", "_all_atom_model.pdb"))
    assert "run_pulchra" in sol.time_cost and path.exists(), path
    assert "phenix_refine" in sol.time_cost and sol.phenix_command
    atoms = pdb_io.parse_pdb(path)
    assert np.isfinite(pdb_io.coords(atoms)).all()
    residues = {}
    for at in atoms:
        key = (str(at["chain"]), int(at["res_id"]))
        residues.setdefault(key, (str(at["res_name"]), set()))[1].add(str(at["name"]))
    assert set(residues) == {(str(at["chain"]), int(at["res_id"])) for at in placed}
    for key, (res, names) in residues.items():
        assert {"N", "CA", "C", "O"} <= names, (key, res, names)
        assert len(names) == 4 + SIDE_CHAIN[res], (key, res, names)


def test_modelling_path_through_the_cli_solver(card, tmp_path):
    """Map + FASTA + AF3 template + docked model on disk -> CA and all-atom
    models, through the ``Solver`` that ``cli.run`` builds from its flags
    (``--run_pulchra --run_phenix``, a ``.pth``) at base 64: ``check_seq``;
    prediction with the four volumes kept on the card (checked as
    ``predict_map``'s, the launches as ``_predict_launches_ok``), device
    extraction on them; then from the scenario's perfect volumes on the
    card: device candidates equal to the host's in order and prediction
    and within 1e-12, ``model_from_volumes`` placing > 60 % of the chain
    at a median distance < 1.5 A, and the all-atom model
    (``_all_atom_ok``)."""
    from mica_tpu_torch.cli import run as cli_run
    from mica_tpu_torch.io import pdb as pdb_io
    from mica_tpu_torch.io.mrc import write_mrc
    from mica_tpu_torch.trace.candidates import extract_candidates
    from mica_tpu_torch.trace.candidates_device import extract_candidates_device
    from mica_tpu_torch.utils.synthetic import make_scenario, random_rigid

    n = MAP
    ca, seq, perfect = make_scenario(n_res=N_RES, shape=(n, n, n), seed=SEED)
    res3 = [pdb_io.ONE_TO_THREE.get(ch, "ALA") for ch in seq]
    keys = ("carbon_alpha_probability", "backbone_probability", "amino_acid_probability")
    inp = tmp_path / "input"
    template = inp / "AF3_structures" / "synth"
    template.mkdir(parents=True)
    # the density is the protein-shaped backbone volume; the template is
    # the chain moved rigidly, the docked model the chain in place
    write_mrc(tmp_path / "emd_0001.mrc",
              np.transpose(perfect["backbone_probability"], (2, 1, 0)), voxel_size=1.0)
    (tmp_path / "0001.fasta").write_text(f">synth|Chains A\n{seq}\n")
    rot, shift = random_rigid(SEED + 7)
    pdb_io.write_ca_pdb(template / "ranked_0.pdb", [ca @ rot.T + shift],
                        res_names_by_chain=[res3])
    pdb_io.write_ca_pdb(inp / "input_af3_docked.pdb", [ca], res_names_by_chain=[res3])
    torch.save({"model_state_dict": _model().state_dict()}, tmp_path / "weights.pth")
    sol = cli_run.build_solver(cli_run.build_parser().parse_args([
        "-m", str(tmp_path / "emd_0001.mrc"), "-f", str(tmp_path / "0001.fasta"), "-i",
        str(inp), "-o", str(tmp_path / "out"), "--model_path", str(tmp_path / "weights.pth"),
        "--batch_size", str(BATCH), "--base_filters", str(BASE), "--seed", str(SEED),
        "--run_pulchra", "--run_phenix"]))
    cfg = sol.config
    assert (cfg.protocol, cfg.window_core, cfg.window_halo, cfg.dtype, cfg.device,
            cfg.run_pulchra, cfg.run_phenix) == ("AF3_struct", 48, 8, torch.bfloat16, "cuda",
                                                 True, True), cfg
    assert sol.check_seq() == "success"

    # the network stage and extraction on what it predicted
    before = ranks.launch_counts()
    sol.predict()
    extract_candidates_device(*(sol.volumes[k] for k in keys))
    torch.cuda.synchronize()
    _predict_launches_ok(ranks.launched_since(before), sol.predictor_timing)
    assert sol.prepared.volume.shape == (n, n, n)
    for k, v in sol.volumes.items():
        assert isinstance(v, torch.Tensor) and v.is_cuda, f"{k} left the card"
    _volumes_ok({k: sol.volumes[k] for k in PROBS}, n)
    pred = sol.volumes["amino_acid_prediction"]
    assert pred.min().item() >= 0 and pred.max().item() <= 19

    # the modelling stages from the scenario's perfect volumes on the card;
    # ``Solver.run`` is ``check_seq``, ``predict`` and this call
    sol.set_volumes({k: torch.from_numpy(v).cuda() for k, v in perfect.items()},
                    prepared=sol.prepared)
    sol.extraction_stats = {}
    assert sol.model_from_volumes() == "success"
    host = extract_candidates(*(perfect[k] for k in keys), perfect["amino_acid_prediction"],
                              cluster_method="morphology")
    assert sol.extraction_stats.get("n_candidates"), "the device extraction found nothing"
    assert len(sol.cands) == len(host)
    np.testing.assert_array_equal(sol.cands.aa_pred, host.aa_pred)
    assert np.abs(sol.cands.coords - host.coords).max() <= 1e-12
    assert np.abs(sol.cands.aa_prob - host.aa_prob).max() <= 1e-12
    placed = pdb_io.select(pdb_io.parse_pdb(sol.ca_model_path), name="CA")
    assert len(placed) > 0.6 * len(ca), (len(placed), len(ca))
    dist = np.linalg.norm(pdb_io.coords(placed)[:, None, :] - ca[None, :, :], axis=-1).min(1)
    assert np.median(dist) < 1.5
    _all_atom_ok(pdb_io, sol, placed)


def _grad_inputs(seed):
    rng = np.random.default_rng(seed + 3)
    x = torch.from_numpy(rng.random((2, 16, 16, 16, 1)).astype(np.float32))
    af = torch.from_numpy((rng.random((2, 16, 16, 16, 24)) < 0.03).astype(np.float32))
    af[0] = 0.0
    tgt = [torch.from_numpy(rng.integers(0, k, (2, 16, 16, 16))) for k in (4, 4, 21)]
    return x, af, tgt


def _grads(state, dtype, dev) -> dict:
    """The base-64 model's gradient at the weights ``state`` on
    ``_grad_inputs``, dropout off, by parameter, in f64 on the host."""
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.train.loss import multi_task_loss, task_lambdas

    model = MICA(base=BASE, dtype=dtype)
    model.load_state_dict(state)
    model.to(dev)
    x, af, tgt = _grad_inputs(SEED)
    loss, _ = multi_task_loss(model(x.to(dev), af.to(dev), train=True),
                              [t.to(dev) for t in tgt], task_lambdas(0))
    loss.backward()
    return {k: p.grad.detach().double().cpu().ravel() for k, p in model.named_parameters()}


def _agreement(card, ref):
    """(cosine of the whole gradient, worst cosine of a tensor above 1e-4
    of the largest reference norm, that tensor's name)."""
    cos_of = torch.nn.functional.cosine_similarity
    whole = cos_of(torch.cat(list(card.values())), torch.cat([ref[k] for k in card]), dim=0)
    gmax = max(v.norm().item() for v in ref.values())
    cos = {k: cos_of(card[k], ref[k], dim=0).item()
           for k in ref if ref[k].norm().item() >= 1e-4 * gmax}
    worst = min(cos, key=cos.get)
    return whole.item(), cos[worst], worst


def test_trainer_at_base_64_and_its_gradient_against_the_f32_cpu(card):
    """``Trainer`` at base 64, bf16, batch 8 of 64^3 ``synthetic_batch``
    windows, recomputation and augmentation on, the epoch-0 dropout: 2
    warm-up steps, then 5 with finite losses and gradient norms and the
    launches of ``TRAIN_PER_STEP`` a step (no inference-only kernel); 8
    steps on one fixed batch whose loss falls.  Then 2 x 16^3 gradients
    of the card (bf16, kernels) against the f32 CPU, dropout off, at the
    weights initialised from the seed (``GRAD_FRESH_MIN``, whole vector
    and worst tensor) and at the trained weights (``GRAD_TRAINED_MIN``)."""
    from mica_tpu_torch.models.mica import dropout_rate_for_epoch
    from mica_tpu_torch.train.data import synthetic_batch
    from mica_tpu_torch.train.loss import task_lambdas
    from mica_tpu_torch.train.trainer import Trainer

    trainer = Trainer(base_filters=BASE, dtype=torch.bfloat16, seed=SEED)
    state = trainer.init_state()
    batch = [torch.as_tensor(b).cuda() for b in synthetic_batch(BATCH, WIN, SEED)]
    lambdas, rate = task_lambdas(0), dropout_rate_for_epoch(0)
    for _ in range(2):
        trainer.train_step(state, batch, lambdas, rate)
    steps = 5
    before = ranks.launch_counts()
    mets = [trainer.train_step(state, batch, lambdas, rate) for _ in range(steps)]
    torch.cuda.synchronize()
    counts = ranks.launched_since(before)
    values = [float(m[k]) for m in mets for k in ("total_loss", "gradient_norm")]
    assert all(math.isfinite(v) for v in values), values
    assert {k: counts[k] / steps for k in TRAIN_PER_STEP} == TRAIN_PER_STEP
    assert {k: counts[k] for k in INFERENCE_ONLY} == dict.fromkeys(INFERENCE_ONLY, 0)

    # one fixed batch, no augmentation or blanking: the loss falls
    trainer.use_augmentation, trainer.exp_only_prob = False, 0.0
    fixed = [float(trainer.train_step(state, batch, lambdas, rate)["total_loss"])
             for _ in range(8)]
    assert all(math.isfinite(v) for v in fixed) and fixed[-1] < fixed[0], fixed
    trained = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    del trainer, state, batch
    torch.cuda.empty_cache()

    fresh = _model(dtype=torch.float32).state_dict()
    whole, worst, name = _agreement(_grads(fresh, torch.bfloat16, "cuda"),
                                    _grads(fresh, torch.float32, "cpu"))
    assert whole >= GRAD_FRESH_MIN[0], whole
    assert worst >= GRAD_FRESH_MIN[1], (name, worst)
    whole, _, _ = _agreement(_grads(trained, torch.bfloat16, "cuda"),
                             _grads(trained, torch.float32, "cpu"))
    assert whole >= GRAD_TRAINED_MIN, whole


def test_f32_on_the_card_takes_the_library_route(card, tmp_path):
    """f32 on the card, the route the JAX package's f32 takes: library
    convs with cuDNN's TF32 off inside the forward and the step (restored
    after), no K1-K8 launch.  At base 64 on a 16^3 map, against the CPU
    within 1e-4: ``predict_map``, ``python -m mica_tpu_torch.cli.predict
    --float32`` as a subprocess (its float16 aa within 1e-3), ``cli.run
    --float32``'s solver through its network stage, volumes kept on the
    card; the f32 gradient at cosine ``F32_GRAD_MIN``; two ``Trainer``
    steps with finite losses; ``cli.train --dtype float32`` for one epoch
    in this process (one checkpoint, a finite validation loss)."""
    from mica_tpu_torch.cli import run as cli_run
    from mica_tpu_torch.cli import train as cli_train
    from mica_tpu_torch.infer.pipeline import predict_map
    from mica_tpu_torch.io.mrc import read_mrc
    from mica_tpu_torch.train import data as data_mod
    from mica_tpu_torch.train.loss import task_lambdas
    from mica_tpu_torch.train.trainer import Trainer

    kw = dict(batch_size=BATCH, dtype=torch.float32, base_filters=BASE, core=F32_CORE, halo=8)
    model = _model(seed=SEED + 5, dtype=torch.float32)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    tf32_seen = []
    model.input_processing.register_forward_hook(
        lambda *_: tf32_seen.append(torch.backends.cudnn.allow_tf32))

    def worst(got, want):
        return max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()) for k in PROBS)

    def no_kernels(counts):
        return {k: counts[k] for k in F32_KERNELS if counts[k]} == {}

    map_path, pdb_path = ranks.card_map(tmp_path, F32_MAP, SEED + 5)
    ref = predict_map(str(map_path), state, docked_pdb_path=str(pdb_path), device="cpu", **kw)
    before = ranks.launch_counts()
    got = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path), **kw)
    assert no_kernels(ranks.launched_since(before))
    assert tf32_seen and not any(tf32_seen), tf32_seen
    assert torch.backends.cudnn.allow_tf32, "the f32 forward did not restore TF32"
    assert worst(got, ref) <= 1e-4

    # the CLI, as a user runs it: on the card by default
    torch.save({"model_state_dict": state}, tmp_path / "weights.pth")
    proc = subprocess.run(
        [sys.executable, "-m", "mica_tpu_torch.cli.predict", "-m", str(map_path), "-o",
         str(tmp_path / "cli"), "--docked_model", str(pdb_path), "--model_checkpoint",
         str(tmp_path / "weights.pth"), "--float32", "--window_core", str(F32_CORE),
         "--batch_size", str(BATCH)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for k in PROBS[:2]:
        vol = read_mrc(tmp_path / "cli" / f"{k}.mrc").to_xyz()[0]
        assert np.abs(vol.astype(np.float64) - ref[k]).max() <= 1e-4, k
    aa16 = np.load(tmp_path / "cli" / "amino_acid_probability.npz")["data"]
    assert np.abs(aa16.astype(np.float64) - ref["amino_acid_probability"]).max() <= 1e-3

    # cli.run --float32: the solver the CLI builds, through its network stage
    inp = tmp_path / "input"
    inp.mkdir()
    (inp / "input_af3_docked.pdb").write_text(pdb_path.read_text())
    (tmp_path / "seq.fasta").write_text(">synth|Chains A\nACDEFGHIKLMNPQRSTVWY\n")
    sol = cli_run.build_solver(cli_run.build_parser().parse_args([
        "-m", str(map_path), "-f", str(tmp_path / "seq.fasta"), "-i", str(inp), "-o",
        str(tmp_path / "out"), "--model_path", str(tmp_path / "weights.pth"), "--float32",
        "--protocol", "AF3_struct_free", "--window_core", str(F32_CORE),
        "--batch_size", str(BATCH), "--base_filters", str(BASE)]))
    assert (sol.config.dtype, sol.config.device) == (torch.float32, "cuda"), sol.config
    assert sol.check_seq() == "success"
    before = ranks.launch_counts()
    sol.predict()
    assert no_kernels(ranks.launched_since(before))
    assert all(sol.volumes[k].is_cuda for k in PROBS), "cli.run volumes left the card"
    assert worst({k: sol.volumes[k].cpu().numpy() for k in PROBS}, ref) <= 1e-4
    del sol

    # training: the card's f32 gradient against the CPU's, then steps
    before = ranks.launch_counts()
    fresh = _model(dtype=torch.float32).state_dict()
    whole, _, _ = _agreement(_grads(fresh, torch.float32, "cuda"),
                             _grads(fresh, torch.float32, "cpu"))
    assert whole >= F32_GRAD_MIN, whole
    trainer = Trainer(base_filters=BASE, dtype=torch.float32, seed=SEED)
    tstate = trainer.init_state()
    tf32_seen.clear()
    trainer.model.input_processing.register_forward_hook(
        lambda *_: tf32_seen.append(torch.backends.cudnn.allow_tf32))
    batch = [torch.as_tensor(b).cuda() for b in data_mod.synthetic_batch(2, 2 * F32_CORE, SEED)]
    losses = [float(trainer.train_step(tstate, batch, task_lambdas(0), 0.01)["total_loss"])
              for _ in range(2)]
    assert all(math.isfinite(v) for v in losses), losses
    assert tf32_seen and not any(tf32_seen), tf32_seen
    del trainer, tstate, batch
    data_mod.ArrayDataset(*data_mod.synthetic_batch(4, 2 * F32_CORE, SEED + 1)).save(
        str(tmp_path / "grids.npz"))
    code = cli_train.main(["--data_path", str(tmp_path / "grids.npz"), "--output_path",
                           str(tmp_path / "trained"), "--batch_size", "2", "--num_epochs", "1",
                           "--val_fraction", "0.5", "--dtype", "float32",
                           "--base_filters", str(BASE), "--log_dir", str(tmp_path / "logs"),
                           "--seed", str(SEED)])
    assert code == 0
    ckpt = sorted((tmp_path / "trained").glob("mica_epoch_0*.pt"))
    assert len(ckpt) == 1, ckpt
    assert math.isfinite(float(torch.load(ckpt[0], map_location="cpu",
                                          weights_only=False)["val_loss"]))
    assert no_kernels(ranks.launched_since(before))


def _helix_chain(n: int, seed: int):
    """A helix-like CA walk with N and C atoms offset from each CA."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * (100.0 * np.pi / 180.0)
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(n)], 1)
    ca += rng.normal(0, 0.2, ca.shape)
    n_xyz = ca + rng.normal([-1.2, 0.3, -0.5], 0.05, ca.shape)
    c_xyz = ca + rng.normal([1.2, -0.4, 0.4], 0.05, ca.shape)
    return rng.integers(0, 20, n), n_xyz, ca, c_xyz


def _write_backbone_cif(path: Path, chains: dict, seed: int) -> None:
    """An AF3-style mmCIF of chains {id: (n, 3) CA coords}: N, CA, C and O
    in every residue, random residue types."""
    from mica_tpu_torch.io.pdb import AMINO_ACIDS

    rng = np.random.default_rng(seed)
    fields = ("group_PDB id type_symbol label_atom_id label_alt_id label_comp_id "
              "label_asym_id label_entity_id label_seq_id auth_seq_id auth_asym_id "
              "Cartn_x Cartn_y Cartn_z occupancy B_iso_or_equiv").split()
    rows, serial = [], 1
    for cid, ca in chains.items():
        for r, xyz in enumerate(ca):
            res = AMINO_ACIDS[rng.integers(len(AMINO_ACIDS))]
            for name, ofs in (("N", (-1.2, 0.3, -0.5)), ("CA", (0, 0, 0)),
                              ("C", (1.2, -0.4, 0.4)), ("O", (2.2, -1.1, 0.2))):
                x, y, z = np.asarray(xyz) + ofs
                rows.append(f"ATOM {serial} {name[0]} {name} . {res} {cid} 1 {r + 1} {r + 1} "
                            f"{cid} {x:.3f} {y:.3f} {z:.3f} 1.00 80.00")
                serial += 1
    path.write_text("data_af3\n#\nloop_\n" + "".join(f"_atom_site.{f}\n" for f in fields)
                    + "\n".join(rows) + "\n#\n")


def test_prep_with_merizo_on_the_card(card, tmp_path, monkeypatch, capsys):
    """Random Merizo shards from the seed under ``MICA_MERIZO_WEIGHTS``;
    Merizo on a ``MERIZO_RES``-residue chain on the card against the CPU
    (logits within ``MERIZO_TOL``, the domain argmax equal where the top
    two are further apart; 6 forwards counted on the card); ``cli.prep
    af3-results`` on two AF3 models of two chains (one of 520 residues in
    two domains): every chain converted with all its residues, >= 4
    domains, domain files inside their chains, Merizo on the card for
    every chain of >= 50 CAs; ``cli.prep af3-json`` (the DNA entry
    skipped, X removed); ``cli.prep dock --dry_run``: the map thresholded
    at the contour, a PHENIX command a domain."""
    from mica_tpu_torch.cli import prep as cli_prep
    from mica_tpu_torch.io import pdb as pdb_io
    from mica_tpu_torch.io.mrc import read_mrc, write_mrc
    from mica_tpu_torch.models import merizo
    from mica_tpu_torch.prep.dock import dock_structures
    from mica_tpu_torch.utils.synthetic import make_chain

    torch.manual_seed(SEED)
    sd = merizo.Merizo().state_dict()
    wdir = tmp_path / "merizo_weights"
    wdir.mkdir()
    keys = list(sd)
    for i in range(3):
        torch.save({k: sd[k] for k in keys[i::3]}, wdir / f"weights_part_{i}.pt")
    monkeypatch.setenv("MICA_MERIZO_WEIGHTS", str(wdir))
    merizo._load_weights_cached.cache_clear()
    try:
        # Merizo on the card against its CPU forward
        aa, n_xyz, ca, c_xyz = _helix_chain(MERIZO_RES, SEED)
        rot, trans = merizo.gram_schmidt_frames(n_xyz, ca, c_xyz)
        feats = {"s": np.eye(20, dtype=np.float32)[aa],
                 "z": np.linalg.norm(ca[:, None] - ca[None], axis=-1).astype(np.float32),
                 "rot": rot.astype(np.float32), "trans": trans.astype(np.float32),
                 "ri": np.arange(1, MERIZO_RES + 1, dtype=np.float32), "ca_xyz": ca}
        on_card, host = merizo.load_weights(str(wdir)), merizo.load_weights(str(wdir), "cpu")
        cuda_before = merizo.forwards["cuda"]
        for _ in range(6):
            got = merizo._forward(on_card, feats)
        assert merizo.forwards["cuda"] == cuda_before + 6
        want = merizo._forward(host, feats)
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= MERIZO_TOL
        top2 = np.sort(want[0], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > MERIZO_TOL
        assert (np.argmax(got[0], -1) == np.argmax(want[0], -1))[clear].all()

        # cli.prep af3-results: two models, two chains each
        inp = tmp_path / "inputs" / "synth"
        results = inp / "AF3_results"
        chain_sizes = {}
        for m, (fold, chains) in enumerate(PREP_CHAINS.items()):
            coords = {}
            for c, (cid, doms) in enumerate(chains.items()):
                parts = [make_chain(n, (60, 60, 60), SEED + 10 * m + 3 * c + d)
                         + np.array([70.0 * d, 0, 0]) for d, n in enumerate(doms)]
                coords[cid] = np.concatenate(parts)
                chain_sizes[f"{fold}_model_0_chain_{cid}"] = len(coords[cid])
            (results / fold).mkdir(parents=True)
            _write_backbone_cif(results / fold / f"{fold}_model_0.cif", coords, SEED + m)
        calls = []
        segment = merizo.segment_chain_atoms

        def recorded(atoms, *a, **kw):
            before = dict(merizo.forwards)
            out = segment(atoms, *a, **kw)
            calls.append(dict(cas=int(len(pdb_io.select(atoms, name="CA"))),
                              **{k: merizo.forwards[k] - before[k] for k in before}))
            return out

        monkeypatch.setattr(merizo, "segment_chain_atoms", recorded)
        capsys.readouterr()
        assert cli_prep.main(["af3-results", "-a", str(results)]) == 0
        counts = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert counts == {"converted": 2, "failed": 0, "chains": 4,
                          "domains": counts["domains"]} and counts["domains"] >= 4, counts
        assert sorted(c["cas"] for c in calls) == sorted(n for n in chain_sizes.values()
                                                          if n >= 50)
        assert all(c["cuda"] >= 1 and not c["cpu"] for c in calls), calls
        for stem, n in chain_sizes.items():
            chain_pdb = inp / "AF3_chains" / f"{stem}.pdb"
            assert chain_pdb.exists(), chain_pdb.name
            chain_res = set(pdb_io.parse_pdb(chain_pdb)["res_id"].tolist())
            assert len(chain_res) == n, chain_pdb.name
            doms = sorted((inp / "AF3_domains").glob(f"{stem}_domain_*.pdb"))
            assert doms, f"no domain file of {stem}"
            for d in doms:
                dres = set(pdb_io.parse_pdb(d)["res_id"].tolist())
                assert dres and dres <= chain_res, f"{d.name} leaves its chain"

        # cli.prep af3-json
        fasta = tmp_path / "synth.fasta"
        fasta.write_text(">synth_1|Chains A, B\nMKTAYIAKQRQISFVKSHFSRQLEERLG\n"
                         ">synth_2|Chain C\nMSXXKLLVAGHX\n>dna\nACGTACGTACGT\n")
        assert cli_prep.main(["af3-json", "-f", str(fasta), "-i", str(tmp_path / "inputs")]) == 0
        jdir = tmp_path / "inputs" / "synth" / "AF3_JSON"
        assert sorted(p.name for p in jdir.glob("*.json")) == ["synth_1.json", "synth_2.json"]
        j1 = json.loads((jdir / "synth_1.json").read_text())[0]
        j2 = json.loads((jdir / "synth_2.json").read_text())[0]
        assert [s["proteinChain"]["id"] for s in j1["sequences"]] == ["A", "B"]
        assert j2["sequences"][0]["proteinChain"]["sequence"] == "MSKLLVAGH"
        assert j1["dialect"] == "alphafold3"

        # cli.prep dock --dry_run: PHENIX is absent, its commands are made
        data = np.zeros((64, 64, 64), np.float32)
        data[8:56, 8:56, 8:56] = np.random.default_rng(SEED).random((48, 48, 48))
        write_mrc(tmp_path / "map.mrc", data, voxel_size=1.0)
        capsys.readouterr()
        assert cli_prep.main(["dock", "-m", str(tmp_path / "map.mrc"), "-i", str(inp),
                              "--resolution", "3.5", "--contour_level", "0.5",
                              "--dry_run"]) == 0
        dock_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        domains = sorted(str(p) for p in (inp / "AF3_domains").glob("*.pdb"))
        assert dock_out == {"docked": 0, "merged": None, "commands": len(domains)}, dock_out
        thr = read_mrc(inp / "docking_work" / "docking_map_0.mrc").data
        assert not ((thr > 0) & (thr < 0.5)).any(), "dock's map not thresholded"
        cmds = dock_structures(str(tmp_path / "map.mrc"), domains, 3.5, 0.5,
                               str(tmp_path / "dock_check"), dry_run=True)["commands"]
        assert len(cmds) == len(domains)
        for c in cmds:
            assert "phenix.dock_in_map search_model=" in c and "resolution=3.5" in c
            assert f"map_file={tmp_path / 'dock_check' / 'docking_map_0.mrc'}" in c
    finally:
        merizo._load_weights_cached.cache_clear()


def _rebuild_from_dumps(files, halo: int):
    """A volume from reference-layout dumps: each window's core, cropped to
    the volume by its di/dj/dk, pasted at its i/j/k."""
    vol = None
    for f in files:
        z = np.load(f, allow_pickle=True)
        data, m = z["data"], z["metadata"].item()
        if vol is None:
            vol = np.zeros(data.shape[:-3] + tuple(int(s) for s in m["orig_shape"]), data.dtype)
        i, j, k, di, dj, dk = (m[c] for c in ("i", "j", "k", "di", "dj", "dk"))
        vol[..., i:i + di, j:j + dj, k:k + dk] = data[..., halo:halo + di, halo:halo + dj,
                                                      halo:halo + dk]
    return vol


def test_reference_dumps_at_base_64(card, tmp_path):
    """``predict_map`` and ``cli.predict --npz_dir`` with reference-layout
    dumps at base 64, bf16, on a 96^3 map with empty windows: 8 windows,
    four files a window, K9 and K10 once a computed batch, the volumes
    rebuilt from the files equal to the returned ones (Dice 1) and to the
    written ones (aa in float16); several maps with ``--npz_dir`` refused
    before any file is written."""
    from scipy.ndimage import gaussian_filter

    from mica_tpu_torch.cli import predict as cli_predict
    from mica_tpu_torch.infer.pipeline import predict_map
    from mica_tpu_torch.io.mrc import read_mrc, write_mrc
    from mica_tpu_torch.utils.parity import mask_dice_report

    keys = PROBS + ("amino_acid_prediction",)
    model = _model(seed=SEED + 7)
    n = DUMP_MAP
    vol = np.zeros((n, n, n), np.float32)
    vol[10:70, 12:40, 14:38] = gaussian_filter(
        np.random.default_rng(SEED).random((60, 28, 24)).astype(np.float32), 1.0)
    write_mrc(tmp_path / "map.mrc", np.transpose(vol, (2, 1, 0)), voxel_size=1.0)
    torch.save(model.state_dict(), tmp_path / "ck.pth")

    def rebuilt(dump_dir, launches, timing):
        batches = -(-(timing["n_windows"] - timing["n_empty"]) // BATCH)
        assert timing["n_windows"] == 8 and timing["n_empty"] >= 1, timing
        assert len(list(dump_dir.glob("grid_i*_j*_k*_*.npz"))) == 4 * timing["n_windows"]
        assert (launches["gather_windows"], launches["scatter_cores"]) == (batches, batches)
        return {k: _rebuild_from_dumps(sorted(dump_dir.glob(f"*_{k}.npz")), 8) for k in keys}

    before = ranks.launch_counts()
    out = predict_map(str(tmp_path / "map.mrc"), model, batch_size=BATCH,
                      dtype=torch.bfloat16, base_filters=BASE, core=48, halo=8,
                      dump_windows_dir=str(tmp_path / "d1"), dump_format="reference")
    got = rebuilt(tmp_path / "d1", ranks.launched_since(before), out["timing"])
    for k in keys:
        np.testing.assert_array_equal(got[k], out[k], err_msg=k)
    report = mask_dice_report(got, out)
    assert report["min_dice"] == 1.0 and report["amino_acid_agreement"] == 1.0, report

    before = ranks.launch_counts()
    assert cli_predict.main(["-m", str(tmp_path / "map.mrc"), "-o", str(tmp_path / "out"),
                             "--npz_dir", str(tmp_path / "d2"), "--model_checkpoint",
                             str(tmp_path / "ck.pth"), "--batch_size", str(BATCH),
                             "--base_filters", str(BASE)]) == 0
    got = rebuilt(tmp_path / "d2", ranks.launched_since(before), out["timing"])
    for k in ("backbone_probability", "carbon_alpha_probability", "amino_acid_prediction"):
        written = np.transpose(read_mrc(tmp_path / "out" / f"{k}.mrc").data, (2, 1, 0))
        np.testing.assert_array_equal(got[k].astype(np.float32), written, err_msg=k)
    aa_written = np.load(tmp_path / "out" / "amino_acid_probability.npz")["data"]
    np.testing.assert_array_equal(got["amino_acid_probability"].astype(np.float16), aa_written)
    with pytest.raises(SystemExit) as refused:
        cli_predict.main(["-m", str(tmp_path / "map.mrc"), str(tmp_path / "map.mrc"), "-o",
                          str(tmp_path / "o3"), "--npz_dir", str(tmp_path / "d3")])
    assert refused.value.code == 2 and not (tmp_path / "d3").exists()


@pytest.mark.slow
def test_learned_weights_from_makedata_to_the_demo(card, tmp_path):
    """Training data from (map, model) pairs, a base-16 MICA trained on the
    card, its checkpoints through the CLIs and the synthetic demo on its
    weights (about seven minutes): ``cli.makedata`` in this process on
    ``LEARNED_SCENARIOS`` synthetic pairs at 144^3; the fixture's training
    for ``LEARNED_STEPS``, finite losses, the mean of the last 50 below the
    first 50's, ``LEARNED_PER_STEP`` launches a step (the selection's
    forwards left out) and no inference-only kernel; the weights with the
    best validation Dice (``fx.Selection``) gain >= ``DICE_GAIN_MIN`` of
    held-out backbone Dice over the initial weights'.  On the last step's
    weights: a base-16 forward (2 x 32^3) with ``LEARNED_PER_FORWARD``
    launches within 0.1 of the f32 CPU; ``cli.predict`` on the exported
    ``.pth`` and on a one-epoch ``cli.train`` ``.pt``, finite volumes of
    the map's shape within 0.05 of ``predict_map``; the demo's ``cli.run
    --run_pulchra``: a finite all-atom model with every backbone atom and
    CA coverage >= ``DEMO_COVERAGE_FLOOR``."""
    from mica_tpu_torch.cli import makedata
    from mica_tpu_torch.cli import predict as cli_predict
    from mica_tpu_torch.cli import train as cli_train
    from mica_tpu_torch.infer.engine import postprocess_logits
    from mica_tpu_torch.infer.pipeline import predict_map
    from mica_tpu_torch.io import mrc as mrc_io
    from mica_tpu_torch.io import pdb as pdb_io
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.scripts import synthetic_demo as demo
    from mica_tpu_torch.scripts import train_synth_fixture as fx
    from mica_tpu_torch.train.data import ArrayDataset
    from mica_tpu_torch.train.trainer import Trainer

    base, bf16 = LEARNED_BASE, torch.bfloat16
    fixture = fx.build_parser().parse_args([])
    shape = (fixture.shape,) * 3
    pairs = [fx.write_scenario(seed, shape, fixture.n_res, tmp_path / "pairs")
             for seed in range(LEARNED_SCENARIOS)]
    (tmp_path / "pairs.csv").write_text("".join(f"{m},{p}\n" for m, p in pairs))
    assert makedata.main(["--pairs", str(tmp_path / "pairs.csv"), "--output",
                          str(tmp_path / "packed")]) == 0
    packs = sorted((tmp_path / "packed").glob("*.npz"))
    assert len(packs) == LEARNED_SCENARIOS
    ds = fx.concat([ArrayDataset.load(str(p)) for p in packs])

    trainer = Trainer(base_filters=base, lr=fixture.lr, dtype=bf16, seed=SEED)
    state = trainer.init_state()
    held_outs = [fx.held_out(seed=fx.EVAL_SEED + i) for i in range(LEARNED_HELD_OUT)]
    val = [fx.held_out(seed=fx.VAL_SEED + i) for i in range(LEARNED_VAL)]
    select = fx.Selection(trainer, base, bf16, "cuda", val, LEARNED_SELECT_EVERY)
    init = fx.evaluate(fx.state_dict_of(trainer), base, bf16, "cuda", held_outs)
    aside = dict.fromkeys(ranks.launch_counts(), 0)

    def select_aside(step):
        # the selection's forwards are left out of the training's launches
        before = ranks.launch_counts()
        select(step)
        for k, v in ranks.launched_since(before).items():
            aside[k] += v

    before = ranks.launch_counts()
    res = fx.train(trainer, state, ds, LEARNED_STEPS, fixture.batch, log_every=100,
                   on_step=select_aside)
    counts = {k: v - aside[k] for k, v in ranks.launched_since(before).items()}
    select.measure(LEARNED_STEPS)
    losses = res["losses"]
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    assert np.isfinite(losses).all()
    assert last < first, (first, last)
    assert {k: counts[k] / LEARNED_STEPS for k in LEARNED_PER_STEP} == LEARNED_PER_STEP
    assert {k: counts[k] for k in INFERENCE_ONLY} == dict.fromkeys(INFERENCE_ONLY, 0)
    # the gate reads the kept weights; the exported .pth holds the last
    # step's, as the fixture exports them, and the checks below run on it
    trained = fx.evaluate(select.best[2], base, bf16, "cuda", held_outs)
    assert trained["backbone"] - init["backbone"] >= DICE_GAIN_MIN, (trained, init)
    sd = fx.state_dict_of(trainer)
    del trainer, state, select
    torch.cuda.empty_cache()

    # inference at base 16 on the card: a forward's launches, and the same
    # weights in f32 on the CPU
    held = held_outs[0]
    x = torch.from_numpy(np.stack([held["density"][:32, :32, :32],
                                   held["density"][40:72, 40:72, 40:72]]))[..., None]
    af = torch.from_numpy(np.stack([np.zeros((32, 32, 32, 24), np.float32),
                                    np.moveaxis(held["af3"][:, 40:72, 40:72, 40:72], 0, -1)]))
    on_card = MICA(base=base, dtype=bf16)
    on_card.load_state_dict(sd)
    on_card.cuda().eval()
    cpu = MICA(base=base, dtype=torch.float32)
    cpu.load_state_dict(sd)
    before = ranks.launch_counts()
    with torch.no_grad():
        got = postprocess_logits(*on_card(x.cuda(), af.cuda()))
    torch.cuda.synchronize()
    fwd = ranks.launched_since(before)
    assert fwd == {k: LEARNED_PER_FORWARD.get(k, 0) for k in fwd}, fwd
    with torch.no_grad():
        want = postprocess_logits(*cpu(x, af))
    assert max((g.cpu() - w).abs().max().item() for g, w in zip(got, want)) <= 0.1

    # checkpoints through the CLIs: the exported .pth and a cli.train .pt
    pth = tmp_path / "fixture.pth"
    fx.export_pth(pth, sd, res["epochs"], last)
    assert cli_train.main(["--data_path", str(packs[0]), "--output_path",
                           str(tmp_path / "ck"), "--batch_size", "4", "--num_epochs", "1",
                           "--base_filters", str(base), "--log_dir", str(tmp_path / "logs"),
                           "--seed", str(SEED)]) == 0
    (pt,) = sorted((tmp_path / "ck").glob("mica_epoch_0*.pt"))
    held_map = tmp_path / "heldout.mrc"
    mrc_io.write_mrc(held_map, np.transpose(held["density"], (2, 1, 0)), voxel_size=1.0)
    for path, weights in ((pth, sd),
                          (pt, torch.load(pt, map_location="cpu", weights_only=True)["model"])):
        dest = tmp_path / f"predict_{path.suffix[1:]}"
        assert cli_predict.main(["-m", str(held_map), "-o", str(dest), "--model_checkpoint",
                                 str(path), "--base_filters", str(base)]) == 0
        bb = mrc_io.read_mrc(dest / "backbone_probability.mrc").to_xyz()[0]
        assert bb.shape == held["density"].shape and np.isfinite(bb).all(), path.name
        ref = predict_map(str(held_map), weights, batch_size=8, dtype=bf16,
                          base_filters=base)["backbone_probability"]
        assert np.abs(bb - ref).max() <= 0.05, path.name

    # the demo: cli.run --run_pulchra on these weights
    r = demo.run(demo.build_parser().parse_args(["--model_path", str(pth),
                                                 "--out", str(tmp_path / "demo")]))
    atoms = pdb_io.parse_pdb(r["all_atom_model"])
    assert len(atoms) and np.isfinite(pdb_io.coords(atoms)).all()
    names = {}
    for at in atoms:
        names.setdefault((str(at["chain"]), int(at["res_id"])), set()).add(str(at["name"]))
    assert all({"N", "CA", "C", "O"} <= v for v in names.values())
    assert r["coverage"] >= DEMO_COVERAGE_FLOOR, r


def test_the_ported_scripts_main_launch_their_kernels(card):
    """The ``main`` of ``distill_ew_crash``, ``bench_in_apply`` and
    ``probe_layout_boundary`` in this process: each exits 0, K11 once a
    k1-k4 variant, K12 once, and K2 and K13 launched."""
    from mica_tpu_torch.scripts import bench_in_apply, distill_ew_crash, probe_layout_boundary

    before = ranks.launch_counts()
    for mod in (distill_ew_crash, bench_in_apply, probe_layout_boundary):
        assert mod.main([]) == 0, mod.__name__
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = ranks.launched_since(before)
    assert launches["rows_ew"] == sum(1 for body, _, _ in distill_ew_crash.SPEC.values()
                                      if body != "k5")
    assert launches["masked_sq_stats"] == 1
    assert launches["in_apply"] and launches["scale2"], launches


def test_data_parallel_paths_on_the_card(card, tmp_path):
    """NCCL at world size 1 in this process: two runs of the replicated
    engine on the prediction map equal to the bit to a single-process run
    (two of which are equal to the bit too), launches as
    ``_predict_launches_ok``, and an f32 ``Trainer`` step (cuDNN
    deterministic) no further from a plain step than two plain steps are
    from each other, in loss and parameters.  Two rank processes at world
    size 2 (gloo, both on ``cuda:0``: NCCL refuses two ranks on one card,
    ``torch_parallel_ranks.mgpu_rank``): the replicated engine within
    ``MGPU_WORLD2_TOL`` of world 1 and equal on both ranks, the
    ``shard_volumes`` engine and a second replicated run equal to the bit
    to the first at <= ``MGPU_SHARD_BYTES_MAX`` of its bytes a rank, K10
    once a computed batch and K9 at most; the f32 step within
    ``DP_LOSS_REL`` of world 1's loss at gradient cosine ``DP_GRAD_COS``,
    parameters equal on both ranks; a bf16 step with a finite loss
    launching each of ``DP_KERNELS``.  Then ``dryrun_multigpu(2)``."""
    from mica_tpu_torch.infer.engine import SlidingWindowPredictor
    from mica_tpu_torch.infer.pipeline import build_af3_encoding, predict_map
    from mica_tpu_torch.ops import _build
    from mica_tpu_torch.parallel import distributed, dryrun
    from mica_tpu_torch.train.trainer import Trainer

    _build.build()      # here, once: the ranks only load the libraries
    map_path, pdb_path = ranks.card_map(tmp_path, MAP, SEED)
    model = _model()

    # one process, no group: two runs of one predictor
    plain = SlidingWindowPredictor(model, **ENGINE)
    first = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path), predictor=plain)
    prepared = first["prepared_map"]
    enc = build_af3_encoding(prepared, str(pdb_path))
    ref = ranks.probs(first)
    del first
    assert ranks.vol_dist(ranks.probs(plain.predict_volume(prepared.volume, enc)), ref) == 0.0
    np.savez(tmp_path / "world1.npz", bb=ref[0], ca=ref[1], aa=ref[2])
    init = Trainer(base_filters=ranks.DP_BASE, dtype=torch.float32, seed=SEED, use_mesh=False)
    init.init_state()
    sd = {k: v.cpu() for k, v in init.model.state_dict().items()}
    torch.save(sd, tmp_path / "dp_init.pt")
    dp_plain = [ranks.dp_step(sd, SEED, use_mesh=False) for _ in range(2)]

    # NCCL, world size 1, in this process
    distributed.initialize(init_method=f"file://{tmp_path}/nccl_rendezvous", world_size=1,
                           rank=0, backend="nccl", local_rank=0, timeout_seconds=300)
    try:
        mesh = distributed.global_mesh()
        assert str(mesh.device) == "cuda:0" and mesh.distributed, mesh.device
        nccl = SlidingWindowPredictor(model, mesh=mesh, **ENGINE)
        before = ranks.launch_counts()
        out = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path), predictor=nccl)
        torch.cuda.synchronize()
        _predict_launches_ok(ranks.launched_since(before), out["timing"])
        assert ranks.vol_dist(ranks.probs(out), ref) == 0.0
        del out
        assert ranks.vol_dist(ranks.probs(nccl.predict_volume(prepared.volume, enc)), ref) == 0.0
        loss_m, _, params_m = ranks.dp_step(sd, SEED, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert abs(loss_m - dp_plain[0][0]) <= abs(dp_plain[1][0] - dp_plain[0][0])
    assert (np.abs(params_m - dp_plain[0][2]).max()
            <= np.abs(dp_plain[1][2] - dp_plain[0][2]).max())
    del model, ref, nccl, plain
    torch.cuda.empty_cache()

    # world size 2: two rank processes
    rks = dryrun.spawn("torch_parallel_ranks:mgpu_rank", 2,
                       dict(map_path=str(map_path), pdb_path=str(pdb_path), seed=SEED,
                            workdir=str(tmp_path), base=BASE, batch=BATCH),
                       timeout=400, group_timeout=300, pythonpath=[str(Path(__file__).parent)])
    dp = [np.load(tmp_path / f"dp_{r}.npz") for r in range(2)]
    loss1, grads1 = dp_plain[0][0], dp_plain[0][1]
    for r in rks:
        assert r["world1_err"] <= MGPU_WORLD2_TOL, r["world1_err"]
        assert r["shard_err"] == 0.0 and r["rep_spread"] == 0.0, r
        assert r["acc_bytes_shard"] <= MGPU_SHARD_BYTES_MAX * r["acc_bytes_rep"], r
        w = r["timing"]
        batches = -(-(w["n_windows"] - w["n_empty"]) // BATCH)
        assert r["launches"]["scatter_cores"] == batches
        assert 0 < r["launches"]["gather_windows"] <= batches
        assert math.isfinite(r["dp_bf16_loss"])
        assert all(r["dp_bf16_launches"][k] for k in DP_KERNELS), r["dp_bf16_launches"]
        assert abs(r["dp_f32_loss"] - loss1) / abs(loss1) <= DP_LOSS_REL, (r["dp_f32_loss"], loss1)
    assert rks[0]["digest"] == rks[1]["digest"], "the ranks' volumes differ"
    g = dp[0]["grads"]
    assert g @ grads1 / (np.linalg.norm(g) * np.linalg.norm(grads1)) >= DP_GRAD_COS
    np.testing.assert_array_equal(dp[0]["params"], dp[1]["params"])
    dryrun.dryrun_multigpu(2, timeout=300)
