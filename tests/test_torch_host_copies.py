"""The port's own copies of the JAX package's host-only modules against the
originals: identical sources where the copy is verbatim, the same code in
``csrc/fieldcc.cpp`` (comments aside), and the same outputs on the same
inputs where the copy was re-pointed to the port's native library (field
inversion, keccak, transcripts, the SRS file). Exact."""

from pathlib import Path

import numpy as np
import pytest

from circuits_halo2_tpu.ops import curve as JC
from circuits_halo2_tpu.ops import field as JF
from circuits_halo2_tpu.ops import keccak as JK
from circuits_halo2_tpu.utils import srs as JS
from circuits_halo2_tpu.utils import transcript as JT
from circuits_halo2_tpu_torch.ops import curve as TC
from circuits_halo2_tpu_torch.ops import field as TF
from circuits_halo2_tpu_torch.ops import keccak as TK
from circuits_halo2_tpu_torch.utils import srs as TS
from circuits_halo2_tpu_torch.utils import transcript as TT

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT = ROOT / "circuits_halo2_tpu", ROOT / "circuits_halo2_tpu_torch"
SRS = ROOT / "tests" / "fixtures_ptau_hermez-raw-11"


@pytest.mark.parametrize("rel", [
    "ops/curve.py", "ops/pairing.py", "ops/poseidon_constants.json", "models/expr.py",
    "models/cs.py", "models/assignment.py", "models/chips.py",
])
def test_verbatim_copies(rel):
    assert (PORT / rel).read_text() == (JAX_PKG / rel).read_text()


def test_fieldcc_copy_has_the_same_code():
    def code(path):
        return [line for line in path.read_text().splitlines()
                if not line.lstrip().startswith("//")]

    assert code(PORT / "csrc" / "fieldcc.cpp") == code(JAX_PKG / "native" / "fieldcc.cpp")


def test_field_batch_inv_on_the_native_path():
    rng = np.random.default_rng(0)
    vals = [int.from_bytes(rng.bytes(32), "little") % TF.FR_MOD or 1 for _ in range(70)]
    vals[3] = TF.FR_MOD - 1
    got = TF.batch_inv(vals)
    assert got == JF.batch_inv(vals)
    assert got == [pow(v, TF.FR_MOD - 2, TF.FR_MOD) for v in vals]


def test_keccak256():
    for data in (b"", b"abc", bytes(range(200))):
        assert TK.keccak256(data) == JK.keccak256(data)


@pytest.mark.parametrize("name", ["Blake2bTranscript", "KeccakTranscript"])
def test_transcripts_write_read_and_squeeze_alike(name):
    pts = [TC.g1_mul(TC.G1_GEN, 12345), TC.g1_mul(TC.G1_GEN, TF.FR_MOD - 1)]
    ours, theirs = getattr(TT, name)(), getattr(JT, name)()
    for t in (ours, theirs):
        t.common_scalar(7)
        for p in pts:
            t.write_point(p)
        t.write_scalar(TF.FR_MOD - 1)
    assert [ours.squeeze_challenge() for _ in range(3)] == [
        theirs.squeeze_challenge() for _ in range(3)]
    proof = ours.finalize()
    assert proof == theirs.finalize()
    reader = getattr(TT, name)(proof)
    reader.common_scalar(7)
    assert [reader.read_point() for _ in pts] == pts
    assert reader.read_scalar() == TF.FR_MOD - 1


def test_srs_read_and_write(tmp_path):
    ours, theirs = TS.ParamsKZG.read(str(SRS)), JS.ParamsKZG.read(str(SRS))
    assert (ours.k, ours.n, ours.g2, ours.s_g2) == (theirs.k, theirs.n, theirs.g2, theirs.s_g2)
    assert ours.g == theirs.g and ours.g_lagrange == theirs.g_lagrange
    out = tmp_path / "srs.bin"
    ours.write(str(out))
    assert out.read_bytes() == SRS.read_bytes()
    assert JC.g1_to_raw_bytes(ours.g[1]) == TC.g1_to_raw_bytes(theirs.g[1])
