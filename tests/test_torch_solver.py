"""The port's modelling path against the JAX package's, on the CPU.

(a) Both ``Solver``s run clustering, fragments, alignment, the initial
model and gap filling from the same prediction volumes and must write the
same CA model, character for character (or give up with the same message):
every numpy module the port copied is on that path.  With numpy volumes
both take the host extraction, with device arrays (jax arrays / torch
tensors) both take their device extraction.
(b) ``cli.run.main`` drives the whole path from files on the CPU in f32;
the volumes it predicts equal the JAX solver's from the same weights at
atol 1e-4 at halo 2 and 5e-4 at the CLI's own halo 8 (f32 sums in another
order; the larger window's InstanceNorm sums round more coarsely in XLA).
(c) ``cli.run --run_pulchra`` writes the all-atom model and ``--run_phenix``
the PHENIX command (PHENIX is not installed).
"""

import functools
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.infer import engine as jengine
from mica_tpu.models.init import init_params_fast
from mica_tpu.models.mica import MICA as JaxMICA
from mica_tpu.trace import solver as jsolver
from mica_tpu_torch.cli import run as cli_run
from mica_tpu_torch.io import mrc as mrc_io
from mica_tpu_torch.io import pdb as pdb_io
from mica_tpu_torch.models.convert import state_dict_from_jax_params
from mica_tpu_torch.trace import solver as tsolver
from mica_tpu_torch.utils.synthetic import make_scenario, random_rigid

SCENARIOS = {"60res": dict(n_res=60, shape=(64, 64, 64), seed=3),
             "90res": dict(n_res=90, shape=(64, 64, 64), seed=11)}


@pytest.fixture(scope="module")
def scenarios():
    return {k: make_scenario(**kw) for k, kw in SCENARIOS.items()}


def _write_template(root: Path, ca, seq):
    fasta = root / "scn.fasta"
    fasta.write_text(f">scn|Chains A\n{seq}\n")
    R, t = random_rigid(7)
    d = root / "AF3_structures" / "scn"
    d.mkdir(parents=True)
    pdb_io.write_ca_pdb(d / "ranked_0.pdb", [ca @ R.T + t],
                        res_names_by_chain=[[pdb_io.ONE_TO_THREE.get(c, "ALA") for c in seq]])
    return fasta


def _model_text(mod, root: Path, fasta: Path, protocol: str, vols, out: str):
    """Run ``mod.Solver``'s modelling stages; (result message, CA model text)."""
    cfg = mod.ModelingConfig(map_path=str(root / "emd_1234.mrc"), fasta_path=str(fasta),
                             input_dir=str(root), output_path=str(root / out),
                             protocol=protocol, allow_random_weights=True)
    sol = mod.Solver(cfg)
    assert sol.check_seq() == "success"
    sol.set_volumes(dict(vols))
    if mod is tsolver:
        # what the port's ``run`` calls after ``check_seq`` and ``predict``
        msg = sol.model_from_volumes()
        return msg, Path(sol.ca_model_path).read_text() if msg == "success" else "", sol
    sol._timed("clustering", sol._clustering)
    sol._timed("fragModeling", sol.frag_modeling)
    if protocol == "AF3_struct":
        sol._timed("seqStructAlignWithAF3Structure", sol.align_af3)
    elif not sol._timed("seqStructureAlign", sol.align_template_free):
        return "seqStructureAlign error! this case is too hard!", "", sol
    sol._timed("initialModelBuilding", sol.build_initial)
    sol._timed("gapFilling", sol.fill_gaps)
    sol.time_record()
    return "success", Path(sol.ca_model_path).read_text(), sol


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("protocol", ["AF3_struct", "AF3_struct_free"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_solvers_write_identical_ca_models(tmp_path, scenarios, name, protocol, on_device):
    ca, seq, vols = scenarios[name]
    fasta = _write_template(tmp_path, ca, seq)
    jvols = {k: jnp.asarray(v) for k, v in vols.items()} if on_device else vols
    tvols = {k: torch.from_numpy(v) for k, v in vols.items()} if on_device else vols
    want_msg, want, jsol = _model_text(jsolver, tmp_path, fasta, protocol, jvols, "jax_out")
    got_msg, got, tsol = _model_text(tsolver, tmp_path, fasta, protocol, tvols, "torch_out")
    assert got_msg == want_msg
    assert got == want
    assert Path(tsol.ca_model_path).name == Path(jsol.ca_model_path).name
    assert Path(tsol.time_log).read_text().splitlines()[0] == "step,time"
    assert list(tsol.time_cost) == list(jsol.time_cost)
    if want_msg == "success":
        assert want.count("ATOM") > 0.6 * len(ca)
        np.testing.assert_array_equal(tsol.cands.coords, jsol.cands.coords)
        assert tsol.fragments == jsol.fragments
    if on_device:
        assert tsol.extraction_stats["n_candidates"] == len(tsol.cands)


def _write_inputs(tmp_path, ca, seq, density):
    (tmp_path / "input").mkdir()
    mrc_io.write_mrc(tmp_path / "emd_1234.mrc", np.transpose(density, (2, 1, 0)),
                     voxel_size=1.0)
    (tmp_path / "1234.fasta").write_text(f">synth|Chains A\n{seq}\n")
    af_dir = tmp_path / "input" / "AF3_structures" / "synth"
    af_dir.mkdir(parents=True)
    for path in (af_dir / "ranked_0.pdb", tmp_path / "input" / "input_af3_docked.pdb"):
        pdb_io.write_ca_pdb(path, [ca], res_names_by_chain=[list(seq)])


def _capture_solvers(monkeypatch):
    solvers = []
    init = tsolver.Solver.__init__
    monkeypatch.setattr(tsolver.Solver, "__init__",
                        lambda self, *a, **k: (solvers.append(self), init(self, *a, **k))[1])
    return solvers


def _cli_flags(tmp_path):
    return ["-m", str(tmp_path / "emd_1234.mrc"), "-f", str(tmp_path / "1234.fasta"),
            "-i", str(tmp_path / "input"), "--device", "cpu", "--float32",
            "--base_filters", "16", "--window_core", "12", "--batch_size", "4", "--quiet"]


# The CLI has no halo flag (the reference's has none either), so its halo is
# 8.  Halo 2 (set behind the CLI) is the small geometry the engine tests hold
# 1e-4 at.  At the CLI's own 28^3 windows the two f32 engines read 3.0e-4
# apart: XLA's CPU reductions round the InstanceNorm sums of a larger window
# more coarsely than torch's (shown by ``test_torch_engine.py::
# test_cli_window_difference_is_the_reductions_rounding``); 5e-4 holds that
# geometry.
@pytest.mark.parametrize("halo,atol", [(2, 1e-4), (8, 5e-4)])
def test_cli_run_on_the_cpu_matches_the_jax_solver(tmp_path, monkeypatch, halo, atol):
    ca, seq, vols = make_scenario(n_res=24, shape=(36, 36, 36), seed=3)
    _write_inputs(tmp_path, ca, seq, vols["backbone_probability"])
    params = init_params_fast(
        JaxMICA(base=16), (jnp.zeros((1, 8, 8, 8, 1)), jnp.zeros((1, 8, 8, 8, 24))), seed=5)
    ckpt = tmp_path / "weights.pth"
    torch.save({"model_state_dict": state_dict_from_jax_params(params)}, ckpt)

    if halo != 8:
        monkeypatch.setattr(tsolver, "ModelingConfig",
                            functools.partial(tsolver.ModelingConfig, window_halo=halo))
    solvers = _capture_solvers(monkeypatch)
    rc = cli_run.main(_cli_flags(tmp_path) + ["-o", str(tmp_path / "out"),
                                              "--model_path", str(ckpt)])
    assert rc == 0
    sol = solvers[-1]
    assert sol.config.window_halo == halo
    assert Path(sol.ca_model_path).exists() and Path(sol.time_log).exists()
    assert {"getData", "nnPred", "clustering", "fragModeling", "gapFilling"} <= set(sol.time_cost)
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in sol.volumes.items()}

    # the JAX solver from the same weights, in f32 as the port ran
    monkeypatch.setattr(jengine, "SlidingWindowPredictor", functools.partial(
        jengine.SlidingWindowPredictor, dtype=jnp.float32))
    cfg = jsolver.ModelingConfig(
        map_path=str(tmp_path / "emd_1234.mrc"), fasta_path=str(tmp_path / "1234.fasta"),
        input_dir=str(tmp_path / "input"), output_path=str(tmp_path / "jax_out"),
        base_filters=16, window_core=12, window_halo=halo, batch_size=4)
    jsol = jsolver.Solver(cfg, params=params)
    assert jsol.check_seq() == "success"
    # only the volumes are compared here: the JAX device extraction's static
    # point caps need a map of at least that many voxels, which 36^3 is not
    jsol._clustering = lambda: None
    jsol.nn_process()
    for k in ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability"):
        want = np.asarray(jsol.volumes[k])
        assert got[k].shape == want.shape
        print(f"halo {halo}: {k} max |port - JAX| {np.abs(got[k] - want).max():.3e}")
        np.testing.assert_allclose(got[k], want, rtol=0, atol=atol)


def test_cli_run_takes_random_weights_only_when_asked(tmp_path, monkeypatch):
    ca, seq, vols = make_scenario(n_res=24, shape=(36, 36, 36), seed=3)
    _write_inputs(tmp_path, ca, seq, vols["backbone_probability"])
    monkeypatch.setattr(tsolver, "ModelingConfig",
                        functools.partial(tsolver.ModelingConfig, window_halo=2))
    solvers = _capture_solvers(monkeypatch)
    common = _cli_flags(tmp_path)
    with pytest.raises(RuntimeError, match="allow_random_weights"):
        cli_run.main(common + ["-o", str(tmp_path / "out2")])
    # with the flag the network runs; its meaningless volumes may leave the
    # aligner nothing to trace, which it says as the reference's does
    try:
        assert cli_run.main(common + ["-o", str(tmp_path / "out3"),
                                      "--allow_random_weights"]) == 0
    except RuntimeError as e:
        assert "candidate graph too sparse" in str(e)
    assert {"nnPred", "clustering", "fragModeling"} <= set(solvers[-1].time_cost)


@pytest.mark.parametrize("flags", [["--run_pulchra"], ["--run_phenix"],
                                   ["--run_pulchra", "--run_phenix"]])
def test_cli_run_writes_the_all_atom_model_and_phenix_command(tmp_path, monkeypatch, flags):
    """``cli.run`` with the all-atom and PHENIX flags on the CPU.  The network
    stage is replaced by the scenario's perfect volumes (random weights trace
    nothing); PHENIX is absent, so its stage records the command it would
    run.  As in the JAX package, PHENIX refines only a rebuilt model."""
    ca, seq, vols = make_scenario(n_res=24, shape=(36, 36, 36), seed=3)
    _write_inputs(tmp_path, ca, seq, vols["backbone_probability"])
    monkeypatch.setattr(tsolver.Solver, "predict", lambda self: self.set_volumes(dict(vols)))
    solvers = _capture_solvers(monkeypatch)
    assert cli_run.main(_cli_flags(tmp_path) + ["-o", str(tmp_path / "out"),
                                                "--allow_random_weights"] + flags) == 0
    sol = solvers[-1]
    pulchra = "--run_pulchra" in flags
    phenix_too = pulchra and "--run_phenix" in flags
    assert (sol.config.run_pulchra, sol.config.run_phenix) == (pulchra, "--run_phenix" in flags)
    all_atom = Path(sol.ca_model_path.replace("_ca_model.pdb", "_all_atom_model.pdb"))
    assert all_atom.exists() == pulchra == ("run_pulchra" in sol.time_cost)
    assert ("phenix_refine" in sol.time_cost) == phenix_too
    if pulchra:
        atoms = pdb_io.parse_pdb(all_atom)
        n_ca = len(pdb_io.select(pdb_io.parse_pdb(sol.ca_model_path), name="CA"))
        assert n_ca > 0.6 * len(ca)
        for name in ("N", "CA", "C", "O"):
            assert (atoms["name"] == name).sum() == n_ca, name
        assert np.isfinite(pdb_io.coords(atoms)).all()
    if phenix_too:
        assert sol.phenix_command.startswith("source  && cd ")
        assert f"phenix.real_space_refine {all_atom} " in sol.phenix_command
    else:
        assert sol.phenix_command is None


def test_cli_flags_are_the_reference_flags():
    ref = importlib.import_module("mica_tpu.cli.run").build_parser()
    ours = cli_run.build_parser()
    flags = lambda p: {s for a in p._actions for s in a.option_strings}  # noqa: E731
    assert flags(ref) <= flags(ours)
    assert flags(ours) - flags(ref) == {"--float32"}
    defaults = lambda p: {a.dest: a.default for a in p._actions}  # noqa: E731
    rd, od = defaults(ref), defaults(ours)
    assert {k: od[k] for k in rd if k != "device"} == {k: v for k, v in rd.items() if k != "device"}
    assert od["device"] == "cuda"


def test_solver_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    cfg = tsolver.ModelingConfig(map_path="m.mrc", output_path="unused_out",
                                 allow_random_weights=True)
    assert cfg.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsolver.Solver.predict(type("S", (), {"config": cfg})())
