"""The port's copies of the all-atom calibration scripts
(``mica_tpu_torch/tools/allatom_src/calibrate_{backbone,sidechains}.py``)
against the JAX package's, which are loaded by path.

The scripts drive a reference PULCHRA binary that is not in the
repository, so both drive a stand-in oracle here: a shell script that
writes N, CA, C, O at fixed offsets from each CA and every side-chain
atom at a fixed place in the residue's CA frame.  Both scripts' written
headers must be byte-equal.  The backbone run is cut only for time: 106
of its ~6300 training traces (the head of each of its three kinds), the
rotamer pass whole; the side-chain run is the scripts' ``--quick`` mode.
The helpers are numpy code copied as is, so they must agree exactly.
"""

import importlib.util
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mica_tpu_torch.tools.allatom_src import calibrate_backbone as bb_port
from mica_tpu_torch.tools.allatom_src import calibrate_sidechains as sc_port

ROOT = Path(__file__).resolve().parent.parent
JAX_SRC = ROOT / "mica_tpu" / "tools" / "allatom_src"
PORT_SRC = ROOT / "mica_tpu_torch" / "tools" / "allatom_src"

ORACLE = r"""#!/bin/sh
# stand-in for `pulchra -c <ca.pdb>`: writes <stem>.rebuilt.pdb
in="$2"
exec awk -v SC="$MICA_SC_ATOMS" '
function put(name, i, ax, ay, az) {
    printf "ATOM  %5d %-4s %3s A%4d    %8.3f%8.3f%8.3f  1.00  0.00\n", ++serial, " " name, res[i], i, ax, ay, az
}
BEGIN { nt = split(SC, types, ";"); for (t = 1; t <= nt; t++) { split(types[t], kv, ":"); sc[kv[1]] = kv[2] } }
/^ATOM/ && substr($0, 13, 4) == " CA " {
    n++; res[n] = substr($0, 18, 3)
    x[n] = substr($0, 31, 8) + 0; y[n] = substr($0, 39, 8) + 0; z[n] = substr($0, 47, 8) + 0
}
END {
    for (i = 1; i <= n; i++) {
        put("N", i, x[i] - 1.2, y[i] + 0.5, z[i] + 0.1)
        put("CA", i, x[i], y[i], z[i])
        put("C", i, x[i] + 1.3, y[i] + 0.4, z[i] - 0.2)
        put("O", i, x[i] + 1.9, y[i] + 1.2, z[i] - 0.4)
        if (i == 1 || i == n || !(res[i] in sc)) continue
        ax = x[i+1] - x[i-1]; ay = y[i+1] - y[i-1]; az = z[i+1] - z[i-1]
        l = sqrt(ax*ax + ay*ay + az*az); ax /= l; ay /= l; az /= l
        ux = x[i+1] - x[i]; uy = y[i+1] - y[i]; uz = z[i+1] - z[i]
        vx = x[i] - x[i-1]; vy = y[i] - y[i-1]; vz = z[i] - z[i-1]
        bx = uy*vz - uz*vy; by = uz*vx - ux*vz; bz = ux*vy - uy*vx
        l = sqrt(bx*bx + by*by + bz*bz); bx /= l; by /= l; bz /= l
        cx = ay*bz - az*by; cy = az*bx - ax*bz; cz = ax*by - ay*bx
        na = split(sc[res[i]], names, ",")
        for (k = 1; k <= na; k++) {
            s = 0.6 + 0.5 * k; t = 0.3 * k
            put(names[k], i, x[i] + s*bx + t*cx, y[i] + s*by + t*cy, z[i] + s*bz + t*cz)
        }
    }
}' "$in" > "${in%.pdb}.rebuilt.pdb"
"""


def _load(name: str):
    """A JAX-package script as a module, its directory on sys.path for
    the side-chain script's sibling import."""
    sys.path.insert(0, str(JAX_SRC))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}", JAX_SRC / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(str(JAX_SRC))


@pytest.fixture(scope="module")
def jax_scripts():
    return _load("calibrate_backbone"), _load("calibrate_sidechains")


@pytest.fixture
def oracle(tmp_path, monkeypatch):
    path = tmp_path / "pulchra"
    path.write_text(ORACLE)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("MICA_SC_ATOMS", ";".join(
        f"{k}:{','.join(v)}" for k, v in sc_port.SC_ATOMS.items()))
    return path


def test_the_helpers_match_the_jax_scripts(jax_scripts):
    jbb, jsc = jax_scripts
    rng = np.random.default_rng(0)
    for _ in range(200):
        p = rng.normal(scale=3.0, size=(4, 3))
        desc = bb_port.window_descriptors(*p)
        assert desc == jbb.window_descriptors(*p)
        assert bb_port.bin_index(*desc) == jbb.bin_index(*desc)
        np.testing.assert_array_equal(bb_port.window_frame(*p[:3]), jbb.window_frame(*p[:3]))
        assert sc_port.pulchra_bins(*p) == jsc.pulchra_bins(*p)
        np.testing.assert_array_equal(sc_port.sc_frame(*p[:3]), jsc.sc_frame(*p[:3]))
    for r13a, r13b, r14 in rng.uniform((3.5, 3.5, -12.0), (8.0, 8.0, 12.0), size=(300, 3)):
        assert bb_port.bin_index(r13a, r13b, r14) == jbb.bin_index(r13a, r13b, r14)
    thetas, taus = rng.uniform(75, 148, 12), rng.uniform(-180, 180, 11)
    np.testing.assert_array_equal(bb_port.make_trace(thetas, taus), jbb.make_trace(thetas, taus))
    samples = [((1, 2, 3), rng.normal(size=(4, 3)) * s) for s in (0.1, 0.1, 1.0, 1.0, 0.12)]
    got, want = sc_port.cluster(samples), jsc.cluster(samples)
    assert got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)


def _cut(gen):
    """The head of each kind of the backbone script's training traces."""
    def cut(rng):
        traces = gen(rng)
        return traces[:3] + traces[39:139] + traces[-3:]
    return cut


def test_backbone_tables_are_byte_equal(jax_scripts, oracle, tmp_path, monkeypatch):
    jbb, _ = jax_scripts
    outs = {}
    for tag, mod in (("port", bb_port), ("jax", jbb)):
        monkeypatch.setattr(mod, "gen_training_traces", _cut(mod.gen_training_traces))
        outs[tag] = tmp_path / f"backbone_{tag}.h"
        monkeypatch.setattr(sys, "argv", ["calibrate_backbone.py", "--pulchra", str(oracle),
                                          "--out", str(outs[tag])])
        mod.main()
    text = outs["port"].read_bytes()
    assert text == outs["jax"].read_bytes()
    assert b"constexpr float kBackboneTable" in text and b"kChi2Table" in text
    assert b"filled 0 bins" not in text


def test_sidechain_tables_are_byte_equal_run_as_scripts(oracle, tmp_path):
    outs, logs = {}, {}
    for tag, src in (("port", PORT_SRC), ("jax", JAX_SRC)):
        outs[tag] = tmp_path / f"sidechain_{tag}.h"
        logs[tag] = subprocess.run(
            [sys.executable, str(src / "calibrate_sidechains.py"), "--pulchra", str(oracle),
             "--out", str(outs[tag]), "--quick", "--passes", "1", "--seed", "11"],
            check=True, timeout=300, capture_output=True, text=True).stdout
    text = outs["port"].read_bytes()
    assert text == outs["jax"].read_bytes()
    assert "WARNING" not in logs["port"] and b"const ScKey kScKeys_TRP[] = {{" in text
    # one conformation a type: the oracle's side chains are fixed in the frame
    assert b"const int kScConfCounts[] = {" + b", ".join([b"1"] * 19) + b"};" in text


def test_backbone_script_runs_as_a_script():
    r = subprocess.run([sys.executable, str(PORT_SRC / "calibrate_backbone.py"), "--help"],
                       capture_output=True, text=True, timeout=60, check=True)
    for flag in ("--pulchra", "--out", "--extra-ca-pdbs"):
        assert flag in r.stdout
