"""The port's data preparation against the JAX package's, on the CPU.

CIF parsing, AF3 JSON, AF3 result trees, chain renaming, the geometric
segmenter, docking's map edits and commands, the offline EMDB lookup and
the ``cli.prep`` subcommands: equal to the JAX package's, files byte for
byte (an MRC header's label names the package).  The learned
``DomainSegmenter`` at the JAX test's widths, the same weights through
``segmenter_state_dict_from_jax_params``, in f32: logits (|x| <= 10,
cosines times 10) within 1e-4, confidences within 1e-5.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mica_tpu.cli import prep as jcli
from mica_tpu.io import cif as jcif
from mica_tpu.io import mrc as jmrc
from mica_tpu.models import segmenter as jseg
from mica_tpu.prep import af3_json as jaf3_json
from mica_tpu.prep import af3_results as jaf3
from mica_tpu.prep import dock as jdock
from mica_tpu.prep import emdb as jemdb
from mica_tpu_torch.cli import prep as cli
from mica_tpu_torch.io import cif
from mica_tpu_torch.io import mrc as mrc_io
from mica_tpu_torch.io import pdb as pdb_io
from mica_tpu_torch.models import segmenter
from mica_tpu_torch.models.convert import segmenter_state_dict_from_jax_params
from mica_tpu_torch.prep import af3_json, af3_results, dock, emdb
from mica_tpu_torch.utils.synthetic import make_chain

CIF_HEADER = """data_test
#
loop_
_atom_site.group_PDB
_atom_site.id
_atom_site.type_symbol
_atom_site.label_atom_id
_atom_site.label_alt_id
_atom_site.label_comp_id
_atom_site.label_asym_id
_atom_site.label_entity_id
_atom_site.label_seq_id
_atom_site.auth_seq_id
_atom_site.auth_asym_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
_atom_site.occupancy
_atom_site.B_iso_or_equiv
"""
CIF_SAMPLE = CIF_HEADER + """ATOM 1 N N . MET A 1 1 1 A 11.104 6.134 -6.504 1.00 50.00
ATOM 2 C CA . MET A 1 1 1 A 11.639 6.071 -5.147 1.00 50.00
ATOM 3 C CA . ALA B 1 2 2 B 1.000 2.000 3.000 1.00 40.00
HETATM 4 O O . HOH C 1 3 3 C 0.000 0.000 0.000 1.00 30.00
#
"""


def _asym_id(i):
    s, i = "", i + 1
    while i > 0:
        i, r = divmod(i - 1, 26)
        s = chr(ord("A") + r) + s
    return s


def _many_chain_cif(n_chains):
    rows = [f"ATOM {i + 1} C CA . ALA {_asym_id(i)} {i + 1} 1 1 {_asym_id(i)} "
            f"{float(i):.3f} 0.000 0.000 1.00 50.00" for i in range(n_chains)]
    return CIF_HEADER + "\n".join(rows) + "\n#\n"


def _backbone_cif(chains):
    """CIF text of chains {id: (n, 3) CA coords}: N, CA, C, O a residue."""
    rows, serial = [], 1
    for cid, ca in chains.items():
        for r, xyz in enumerate(ca):
            for name, ofs in (("N", (-1.2, 0.3, -0.5)), ("CA", (0, 0, 0)),
                              ("C", (1.2, -0.4, 0.4)), ("O", (2.2, -1.1, 0.2))):
                x, y, z = np.asarray(xyz) + ofs
                rows.append(f"ATOM {serial} {name[0]} {name} . ALA {cid} 1 {r + 1} {r + 1} "
                            f"{cid} {x:.3f} {y:.3f} {z:.3f} 1.00 80.00")
                serial += 1
    return CIF_HEADER + "\n".join(rows) + "\n#\n"


def _two_domain_ca(n1=60, n2=60, sep=35.0, seed=0):
    d1 = make_chain(n1, (64, 64, 64), seed)
    d2 = make_chain(n2, (64, 64, 64), seed + 5) + np.array([sep, 0, 0])
    return np.concatenate([d1, d2])


def _same_atoms(got, want):
    assert got.dtype == want.dtype and len(got) == len(want)
    for name in want.dtype.names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _same_tree(got: Path, want: Path):
    """Two directory trees with the same relative files, byte for byte but
    for an MRC header's first label."""
    g = sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    w = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert g == w and g
    for rel in g:
        a, b = (got / rel).read_bytes(), (want / rel).read_bytes()
        if rel.suffix == ".mrc":  # the first label names the package that wrote it
            a, b = a[:224] + a[304:], b[:224] + b[304:]
        assert a == b, rel


@pytest.mark.parametrize("text", [CIF_SAMPLE, _many_chain_cif(30)], ids=["sample", "30_chains"])
def test_parse_cif_equals_jax(text):
    _same_atoms(cif.parse_cif_atoms(text), jcif.parse_cif_atoms(text))


def test_chain_renaming_equals_jax():
    got, want = cif.parse_cif_atoms(_many_chain_cif(30)), jcif.parse_cif_atoms(_many_chain_cif(30))
    assert af3_results.rename_chains(got) == jaf3.rename_chains(want)
    _same_atoms(got, want)
    assert [af3_results.int_to_chain(i) for i in range(62)] == [
        jaf3.int_to_chain(i) for i in range(62)]
    for mod in (af3_results, jaf3):
        with pytest.raises(mod.OutOfChainsError):
            mod.int_to_chain(62)
        with pytest.raises(mod.OutOfChainsError):
            mod.rename_chains(cif.parse_cif_atoms(_many_chain_cif(63)))


def test_af3_json_equals_jax(tmp_path):
    fasta = tmp_path / "p.fasta"
    fasta.write_text(">prot1|Chains A, B\nMKTAYIAKQRQISFVKSHFSRQ\n>dna\nACGTACGTACGT\n"
                     ">prot2\nMKXXLLVAAX\n")
    got = af3_json.convert_fasta_to_af3_json(str(fasta), str(tmp_path / "port"))
    want = jaf3_json.convert_fasta_to_af3_json(str(fasta), str(tmp_path / "jax"))
    assert [Path(p).name for p in got] == [Path(p).name for p in want] == [
        "prot1.json", "prot2.json"]
    _same_tree(tmp_path / "port", tmp_path / "jax")


def _af3_results(root: Path) -> Path:
    """An AF3 results folder: one model with a two-domain chain A and a
    short chain B, one with the sample's atoms."""
    res = root / "AF3_results"
    (res / "prot1").mkdir(parents=True)
    (res / "prot1" / "fold_prot1_model_0.cif").write_text(
        _backbone_cif({"A": _two_domain_ca(), "B": make_chain(30, (64, 64, 64), 9)}))
    (res / "prot2").mkdir()
    (res / "prot2" / "fold_prot2_model_0.cif").write_text(CIF_SAMPLE)
    return res


@pytest.mark.parametrize("split_domains", [False, True])
def test_process_af3_results_equals_jax(tmp_path, monkeypatch, split_domains):
    monkeypatch.delenv("MICA_MERIZO_WEIGHTS", raising=False)
    got = af3_results.process_af3_results(str(_af3_results(tmp_path / "port")),
                                          split_domains=split_domains, device="cpu")
    want = jaf3.process_af3_results(str(_af3_results(tmp_path / "jax")),
                                    split_domains=split_domains)
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    if split_domains:
        assert sum("prot1_model_0_chain_A_domain" in p for p in got["domains"]) == 2
    _same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("case", ["two_domains", "one_domain", "three_domains"])
def test_geometric_segmenter_equals_jax(case):
    if case == "two_domains":
        ca = _two_domain_ca()
    elif case == "one_domain":
        ca = make_chain(80, (64, 64, 64), 2)
    else:
        ca = np.concatenate([make_chain(n, (64, 64, 64), s) + np.array([x, 0, 0])
                             for n, s, x in ((60, 0, 0.0), (60, 7, 40.0), (120, 11, 90.0))])
    got = segmenter.segment_domains(ca)
    np.testing.assert_array_equal(got, jseg.segment_domains(ca))
    assert len(np.unique(got)) == {"two_domains": 2, "one_domain": 1, "three_domains": 3}[case]


def test_dock_map_edits_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.random((20, 22, 24)).astype(np.float32)
    mrc_io.write_mrc(tmp_path / "map.mrc", data, voxel_size=1.0, axis_order=(3, 2, 1))
    for side, mod, mrc in (("port", dock, mrc_io), ("jax", jdock, jmrc)):
        d = tmp_path / side
        d.mkdir()
        mod.threshold_map(str(tmp_path / "map.mrc"), 0.5, str(d / "t.mrc"))
        pdb_io.write_ca_pdb(d / "docked.pdb", [[[10.0, 9.0, 8.0], [11.0, 10.0, 10.0],
                                                [12.5, 11.0, 9.0]]],
                            res_names_by_chain=[["A", "G", "L"]])
        mod.mask_docked_region(str(d / "t.mrc"), str(d / "docked.pdb"), str(d / "m.mrc"))
        pdb_io.write_ca_pdb(d / "d1_docked.pdb", [[[0, 0, 0], [3.8, 0, 0]]])
        pdb_io.write_ca_pdb(d / "d2_docked.pdb", [[[10, 0, 0], [13.8, 0, 0]]])
        mod.merge_docked_models([str(d / "d1_docked.pdb"), str(d / "d2_docked.pdb")],
                                str(d / "merged.pdb"))
    masked = mrc_io.read_mrc(tmp_path / "port" / "m.mrc").data
    assert (masked == 0).sum() > (mrc_io.read_mrc(tmp_path / "port" / "t.mrc").data == 0).sum()
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_dock_dry_run_equals_jax(tmp_path):
    data = np.full((16, 16, 16), 1.0, np.float32)
    mrc_io.write_mrc(tmp_path / "map.mrc", data, voxel_size=1.0)
    models = []
    for i in range(2):
        pdb_io.write_ca_pdb(tmp_path / f"m{i}.pdb", [[[8.0, 8.0, 4.0 + 6 * i]]])
        models.append(str(tmp_path / f"m{i}.pdb"))
    results = []
    for side, mod in (("port", dock), ("jax", jdock)):
        work = tmp_path / side / "work"
        work.mkdir(parents=True)
        # the second model was docked before: the resume masks its density
        pdb_io.write_ca_pdb(work / "m1_docked.pdb", [[[8.0, 8.0, 10.0]]])
        results.append(mod.dock_structures(str(tmp_path / "map.mrc"), models, 3.0, 0.1,
                                           str(work), phenix_env="phenix/phenix_env.sh",
                                           sequence_path="seq.fasta", dry_run=True))
    got, want = results
    assert got["commands"] == [c.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                               for c in want["commands"]]
    assert len(got["commands"]) == 1 and "phenix.dock_in_map" in got["commands"][0]
    assert [Path(p).name for p in got["docked"]] == ["m1_docked.pdb"]
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_emdb_returns_none_offline(monkeypatch):
    monkeypatch.setitem(sys.modules, "requests", None)  # no network is tried
    assert emdb.extract_map_info("EMD-15635") is None
    assert jemdb.extract_map_info("EMD-15635") is None


def _run_both(capsys, argv_port, argv_jax):
    rc_port = cli.main(argv_port)
    out_port = capsys.readouterr().out.strip().splitlines()
    rc_jax = jcli.main(argv_jax)
    out_jax = capsys.readouterr().out.strip().splitlines()
    return (rc_port, out_port[-1] if out_port else ""), (rc_jax, out_jax[-1] if out_jax else "")


def test_cli_prep_subcommands_equal_jax(tmp_path, capsys, monkeypatch):
    """Each subcommand's exit code and JSON equal the JAX CLI's, and the
    files it writes are equal."""
    monkeypatch.delenv("MICA_MERIZO_WEIGHTS", raising=False)
    monkeypatch.setitem(sys.modules, "requests", None)
    fasta = tmp_path / "seq.fasta"
    fasta.write_text(">prot1|Chains A\nMKTAYIAKQRQISFVKSHFSRQ\n")
    for side in ("port", "jax"):
        _af3_results(tmp_path / side / "in")
        mrc_io.write_mrc(tmp_path / side / "map.mrc", np.ones((16, 16, 16), np.float32),
                         voxel_size=1.0)

    def args(side, *rest):
        return [a.replace("{d}", str(tmp_path / side)) for a in rest]

    cases = [
        ("af3-json", "-f", str(fasta), "-i", "{d}/in"),
        ("af3-results", "-a", "{d}/in/AF3_results"),
        ("dock", "-m", "{d}/map.mrc", "-i", "{d}/in", "--resolution", "3.0",
         "--contour_level", "0.5", "--dry_run"),
        ("emdb", "-e", "15635"),
    ]
    for case in cases:
        extra = ["--device", "cpu"] if case[0] == "af3-results" else []
        got, want = _run_both(capsys, args("port", *case) + extra, args("jax", *case))
        assert got == want, case[0]
        assert want[0] == (1 if case[0] == "emdb" else 0), case[0]
    assert json.loads(want[1]) == {"error": "lookup failed"}
    _same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.fixture(scope="module")
def small_segmenter():
    """The JAX test's configuration: dim 32, z_dim 8, 1 block, 4 domains."""
    ca = _two_domain_ca(6, 6, 20.0)[:12]
    inputs = segmenter.model_inputs(ca, ["ALA", "GLY", "LEU"] * 4)
    flax_model = jseg.build_segmenter()(dim=32, z_dim=8, blocks=1, n_domains=4)
    params = flax_model.init(jax.random.PRNGKey(3), *inputs, np.arange(12))["params"]
    return flax_model, params, inputs


def test_domain_segmenter_equals_flax(small_segmenter):
    flax_model, params, inputs = small_segmenter
    want_logits, want_conf = flax_model.apply({"params": params}, *inputs, np.arange(12))
    model = segmenter.DomainSegmenter(dim=32, z_dim=8, blocks=1, n_domains=4)
    model.load_state_dict(segmenter_state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        logits, conf = model(*(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4)
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_conf), atol=1e-5)


def test_segment_with_model_equals_jax():
    """At the default widths, on a two-domain chain, the learned labels of
    both packages agree; on the port a failure raises."""
    ca = _two_domain_ca(30, 30, 30.0, seed=4)
    names = ["ALA", "GLY", "LEU"] * 20
    inputs = segmenter.model_inputs(ca, names)
    params = jseg.build_segmenter()().init(jax.random.PRNGKey(0), *inputs,
                                            np.arange(len(ca)))["params"]
    sd = segmenter_state_dict_from_jax_params(params)
    got = segmenter.segment_with_model(ca, names, sd, min_domain_size=10, device="cpu")
    np.testing.assert_array_equal(got, jseg.segment_with_model(ca, names, params, 10))
    with pytest.raises(RuntimeError, match="size mismatch"):
        segmenter.segment_with_model(ca, names, {**sd, "embed_s.weight": torch.zeros(3, 3)},
                                     device="cpu")
