"""The port's all-atom rebuild and PHENIX wrappers against the JAX package's,
on the CPU.

The port builds ``mica_allatom`` from its own copy of the sources into the
git-ignored ``build/``; the JAX package runs its tracked binary.  Both run
on the same CA models and must write the same all-atom PDB, byte for byte:
a 20-residue ideal helix and ``make_scenario`` chains, in the tool's modes.
The external-PULCHRA path (split at chain and residue gaps, parallel jobs,
merge) runs a stand-in PULCHRA script under both drivers and must give the
same file.  The PHENIX command strings must be equal for the same
arguments (PHENIX is not installed: dry runs).  A ``Solver`` asked for the
rebuild writes ``*_all_atom_model.pdb`` with a complete backbone.
"""

import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest

from mica_tpu.tools import allatom as jallatom
from mica_tpu.tools import phenix as jphenix
from mica_tpu_torch.io import pdb as pdb_io
from mica_tpu_torch.tools import allatom, phenix
from mica_tpu_torch.trace import solver as tsolver
from mica_tpu_torch.utils.synthetic import make_scenario, random_rigid

ROOT = Path(__file__).resolve().parent.parent

# heavy atoms of each residue type as the tool writes them (no hydrogens, no OXT)
SIDE_CHAIN = {"ALA": 1, "ARG": 7, "ASN": 4, "ASP": 4, "CYS": 2, "GLN": 5, "GLU": 5, "GLY": 0,
              "HIS": 6, "ILE": 4, "LEU": 4, "LYS": 5, "MET": 4, "PHE": 7, "PRO": 3, "SER": 2,
              "THR": 3, "TRP": 10, "TYR": 8, "VAL": 3}


def _helix_ca(n=20):
    """Ideal alpha-helix CA trace (``tests/test_allatom_solver.py``'s)."""
    t = np.arange(n) * (100.0 * np.pi / 180.0)
    return np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(n)], axis=1)


def _ca_models(tmp: Path):
    """The helix; a 60-residue scenario chain; the same chain as two chains
    with a residue-number gap in the first (fragments for the tool)."""
    out = {}
    pdb_io.write_ca_pdb(tmp / "helix.pdb", [_helix_ca(20)],
                        res_names_by_chain=[list("MKTAYIAKQRQISFVKSHFS")])
    out["helix"] = tmp / "helix.pdb"
    ca, seq, _ = make_scenario(n_res=60, shape=(64, 64, 64), seed=3)
    res3 = [pdb_io.ONE_TO_THREE.get(c, "ALA") for c in seq]
    pdb_io.write_ca_pdb(tmp / "scenario.pdb", [ca], res_names_by_chain=[res3])
    out["scenario"] = tmp / "scenario.pdb"
    lines = [ln for ln in (tmp / "scenario.pdb").read_text().splitlines() if ln.startswith("ATOM")]
    broken = []
    for ln in lines:
        rid = int(ln[22:26])
        chain = "A" if rid <= 35 else "B"
        rid = rid + 3 if 20 < rid <= 35 else rid      # a gap after residue 20
        broken.append(f"{ln[:21]}{chain}{rid:4d}{ln[26:]}")
    (tmp / "fragments.pdb").write_text("\n".join(broken) + "\nEND\n")
    out["fragments"] = tmp / "fragments.pdb"
    return out


@pytest.fixture(scope="module")
def ca_models(tmp_path_factory):
    return _ca_models(tmp_path_factory.mktemp("ca_models"))


MODES = {"default": {}, "hbond": dict(hbond_optimize=True),
         "ca_opt": dict(ca_optimize=True, max_shift=2.0)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", ["helix", "scenario", "fragments"])
def test_rebuild_is_byte_equal_to_the_jax_tool(tmp_path, ca_models, model, mode):
    got = allatom.rebuild_ca_model(str(ca_models[model]), str(tmp_path / "port.pdb"),
                                   **MODES[mode])
    want = jallatom.rebuild_ca_model(str(ca_models[model]), str(tmp_path / "jax.pdb"),
                                     **MODES[mode])
    assert got == str(tmp_path / "port.pdb") and want == str(tmp_path / "jax.pdb")
    text = Path(got).read_bytes()
    assert text == Path(want).read_bytes()
    atoms = pdb_io.parse_pdb(got)
    n_ca = (atoms["name"] == "CA").sum()
    assert n_ca == len([ln for ln in ca_models[model].read_text().splitlines()
                        if ln.startswith("ATOM")])
    for name in ("N", "C", "O"):
        assert (atoms["name"] == name).sum() == n_ca, name
    assert np.isfinite(pdb_io.coords(atoms)).all()


def test_the_tool_builds_from_the_ports_sources_into_build():
    binary = allatom.ensure_built()
    assert binary == allatom.binary_path() and binary.exists()
    assert binary.parent == ROOT / "build" / "mica_tpu_torch"
    assert binary.name.startswith("mica_allatom-") and os.access(binary, os.X_OK)
    assert allatom.SRC_DIR == ROOT / "mica_tpu_torch" / "tools" / "allatom_src"
    # the copied sources are the JAX package's, byte for byte
    for name in allatom.SOURCES:
        assert (allatom.SRC_DIR / name).read_bytes() == \
            (ROOT / "mica_tpu" / "tools" / "allatom_src" / name).read_bytes(), name
    assert not list(binary.parent.glob("mica_allatom-*.tmp"))
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in allatom.SOURCES:
        (src / name).write_text("int main() { return undeclared_name; }\n")
    monkeypatch.setattr(allatom, "SRC_DIR", src)
    monkeypatch.setattr(allatom, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        allatom.ensure_built()
    assert not list((tmp_path / "build").glob("*"))


def test_a_missing_ca_model_gives_none(tmp_path):
    assert allatom.rebuild_ca_model(str(tmp_path / "absent.pdb"), str(tmp_path / "o.pdb")) is None


def test_split_fragments_equals_the_jax_split(tmp_path, ca_models):
    for model in ("scenario", "fragments"):
        got_dir, want_dir = tmp_path / f"{model}_port", tmp_path / f"{model}_jax"
        got_dir.mkdir()
        want_dir.mkdir()
        got = allatom._split_fragments(str(ca_models[model]), got_dir)
        want = jallatom._split_fragments(str(ca_models[model]), want_dir)
        assert [p.name for p in got] == [p.name for p in want]
        assert [p.read_text() for p in got] == [p.read_text() for p in want]
    assert len(got) == 3     # chain A up to the gap, chain A after it, chain B


STAND_IN_PULCHRA = """#!{python}
import sys
from pathlib import Path
src = Path(sys.argv[1])
assert sys.argv[2:] == ["-c"], sys.argv
out = []
for line in src.read_text().splitlines():
    if line.startswith("ATOM"):
        out.append(line)
        out.append(line[:12] + " N  " + line[16:])
Path(src.stem + ".rebuilt.pdb").write_text("\\n".join(out) + "\\n")
"""


def test_external_pulchra_path_matches_the_jax_driver(tmp_path, ca_models):
    pulchra = tmp_path / "pulchra"
    pulchra.write_text(STAND_IN_PULCHRA.format(python=sys.executable))
    pulchra.chmod(pulchra.stat().st_mode | stat.S_IXUSR)
    got = allatom.rebuild_ca_model(str(ca_models["fragments"]), str(tmp_path / "port.pdb"),
                                   pulchra_path=str(pulchra), max_jobs=2)
    want = jallatom.rebuild_ca_model(str(ca_models["fragments"]), str(tmp_path / "jax.pdb"),
                                     pulchra_path=str(pulchra), max_jobs=2)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    assert Path(got).read_text().count("ATOM") == 2 * 60
    assert allatom.rebuild_ca_model(str(ca_models["helix"]), str(tmp_path / "x.pdb"),
                                    pulchra_path=str(tmp_path / "absent")) is None


@pytest.mark.parametrize("param", ["", "custom.eff"])
def test_real_space_refine_commands_equal_the_jax_modules(tmp_path, param):
    args = ("model.pdb", "map.mrc", 3.2, str(tmp_path / "out"), "/opt/phenix/env.sh", param)
    got = phenix.real_space_refine(*args, dry_run=True)
    want = jphenix.real_space_refine(*args, dry_run=True)
    if not param:
        # each package names its own copy of the default parameters
        assert Path(phenix.DEFAULT_REFINE_PARAMS).read_bytes() == \
            Path(jphenix.DEFAULT_REFINE_PARAMS).read_bytes()
        assert Path(phenix.DEFAULT_REFINE_PARAMS).parent == ROOT / "mica_tpu_torch" / "tools"
        want = want.replace(jphenix.DEFAULT_REFINE_PARAMS, phenix.DEFAULT_REFINE_PARAMS)
    assert got == want and got.startswith("source /opt/phenix/env.sh && cd ")
    # without the environment script the command is returned, nothing runs
    assert phenix.real_space_refine(*args) == got


@pytest.mark.parametrize("sequence", ["", "seq.fasta"])
def test_dock_in_map_commands_equal_the_jax_modules(tmp_path, sequence):
    args = ("af3.pdb", "map.mrc", 3.2, str(tmp_path / "docked.pdb"), "/opt/phenix/env.sh")
    got = phenix.dock_in_map(*args, sequence_path=sequence, nproc=4, dry_run=True)
    assert got == jphenix.dock_in_map(*args, sequence_path=sequence, nproc=4, dry_run=True)
    assert ("sequence=" in got) == bool(sequence)
    assert phenix.dock_in_map(*args, sequence_path=sequence, nproc=4) == got


@pytest.mark.parametrize("phenix_too", [False, True])
def test_solver_writes_the_all_atom_model(tmp_path, phenix_too):
    ca, seq, vols = make_scenario(n_res=60, shape=(64, 64, 64), seed=3)
    fasta = tmp_path / "scn.fasta"
    fasta.write_text(f">scn|Chains A\n{seq}\n")
    rot, shift = random_rigid(7)
    d = tmp_path / "AF3_structures" / "scn"
    d.mkdir(parents=True)
    res3 = [pdb_io.ONE_TO_THREE.get(c, "ALA") for c in seq]
    pdb_io.write_ca_pdb(d / "ranked_0.pdb", [ca @ rot.T + shift], res_names_by_chain=[res3])
    cfg = tsolver.ModelingConfig(map_path=str(tmp_path / "emd_1234.mrc"), fasta_path=str(fasta),
                                 input_dir=str(tmp_path), output_path=str(tmp_path / "out"),
                                 run_pulchra=True, run_phenix=phenix_too,
                                 phenix_act="/opt/phenix/env.sh" if phenix_too else "")
    sol = tsolver.Solver(cfg)
    assert sol.check_seq() == "success"
    sol.set_volumes(dict(vols))
    assert sol.model_from_volumes() == "success"
    path = Path(sol.ca_model_path.replace("_ca_model.pdb", "_all_atom_model.pdb"))
    assert path.name == "1234_scn_MICA_all_atom_model.pdb" and path.exists()
    assert "run_pulchra" in sol.time_cost and ("phenix_refine" in sol.time_cost) == phenix_too
    assert list(sol.time_cost)[-1] == ("phenix_refine" if phenix_too else "run_pulchra")
    assert "run_pulchra," in Path(sol.time_log).read_text()
    atoms = pdb_io.parse_pdb(path)
    placed = pdb_io.parse_pdb(sol.ca_model_path)
    for name in ("N", "CA", "C", "O"):
        assert (atoms["name"] == name).sum() == len(placed), name
    assert np.isfinite(pdb_io.coords(atoms)).all()
    # each residue carries its type's heavy atoms
    counts = {}
    for a in atoms:
        key = (str(a["chain"]), int(a["res_id"]))
        counts.setdefault(key, [str(a["res_name"]), 0])[1] += 1
    assert all(n == 4 + SIDE_CHAIN[r] for r, n in counts.values()), counts
    if phenix_too:
        want = jphenix.real_space_refine(
            str(path), cfg.map_path, cfg.resolution, cfg.output_path, cfg.phenix_act,
            dry_run=True).replace(jphenix.DEFAULT_REFINE_PARAMS, phenix.DEFAULT_REFINE_PARAMS)
        assert sol.phenix_command == want
    else:
        assert sol.phenix_command is None
