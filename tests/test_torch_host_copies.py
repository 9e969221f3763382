"""The port's own copies of the JAX package's host-only modules against the
originals: identical sources where the copy is verbatim (the Solidity
generator differs only in the header line it writes, the operator's round
by its ``device`` keyword and its bulk calldata method, Spartan only by its
MSM route), the
recursion side's host modules and circom sources, the same code in
``csrc/fieldcc.cpp`` (comments aside), and the same outputs on the same
inputs where the copy was re-pointed to the port's native library (field
inversion, keccak, transcripts, the SRS file). Exact."""

import difflib
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
    "models/cs.py", "models/assignment.py", "models/chips.py", "models/mock_prover.py",
    "models/layout.py", "contracts/summa_sim.py", "contracts/yul_vm.py", "contracts/sol_exec.py",
    "contracts/solidity/Summa.sol", "contracts/solidity/IVerifier.sol", "contracts/__init__.py",
    "backend/apis.py", "backend/signer.py", "backend/address_ownership.py",
    "backend/web3_transport.py", "backend/__init__.py",
    "ops/poseidon_round_numbers.py", "ops/grain.py", "ops/poseidon_circom.py", "ops/grumpkin.py",
    "merkle/circom_mst.py", "merkle/circom_r1cs.py", "models/nova_fold.py",
    "models/r1cs_dsl.py", "models/nova_cycle.py",
])
def test_verbatim_copies(rel):
    assert (PORT / rel).read_text() == (JAX_PKG / rel).read_text()


def _differing_lines(rel):
    """(original line, port line) pairs where the two files differ."""
    ours = (PORT / rel).read_text().splitlines()
    theirs = (JAX_PKG / rel).read_text().splitlines()
    matcher = difflib.SequenceMatcher(a=theirs, b=ours, autojunk=False)
    return [(theirs[i1:i2], ours[j1:j2]) for tag, i1, i2, j1, j2 in matcher.get_opcodes()
            if tag != "equal"]


def test_sol_generator_copy_differs_only_in_its_header_line():
    assert _differing_lines("contracts/sol_generator.py") == [
        (["// Generated by circuits_halo2_tpu.contracts.sol_generator"],
         ["// Generated by circuits_halo2_tpu_torch.contracts.sol_generator"])]


def test_round_copy_differs_only_by_the_device_keyword():
    """The port's ``backend/round.py`` is the JAX package's with the
    ``device`` keyword, and with ``Snapshot.generate_proofs_of_inclusion``,
    the bulk calldata path, which only the port has."""
    changed = _differing_lines("backend/round.py")
    assert [line.strip() for _, ours in changed for line in ours] == [
        'device="cuda:0",',
        "k, params_path, levels, n_currencies, n_bytes, device=device",
        "",
        "def generate_proofs_of_inclusion(self, user_indices: list[int]) -> list[MstInclusionProof]:",
        '"""``generate_proof_of_inclusion`` for many users in one batched,',
        "self-checked call (``pipeline.gen_proofs_solidity_calldata``): the",
        "operator's bulk path; each user's calldata is the bytes",
        '``generate_proof_of_inclusion`` exports for that user."""',
        "levels, n_currencies, n_bytes = self.shape",
        "circuits = [MstInclusionCircuit.init(levels, n_currencies, n_bytes,",
        "self.mst.generate_proof(i)) for i in user_indices]",
        "return [MstInclusionProof(c.proof, c.public_inputs)",
        "for c in pipeline.gen_proofs_solidity_calldata(self.trusted_setup, circuits)]",
        'device="cuda:0",',
        "self.snapshot = Snapshot(",
        "mst, params_path, levels, n_currencies, n_bytes, device=device",
        ")",
    ]
    assert [line.strip() for theirs, _ in changed for line in theirs] == [
        "k, params_path, levels, n_currencies, n_bytes",
        "self.snapshot = Snapshot(mst, params_path, levels, n_currencies, n_bytes)",
    ]


@pytest.mark.parametrize("name", ["merkle_sum_tree.circom", "incremental_mst_inclusion.circom"])
def test_circom_sources_copied(name):
    assert (PORT / "circom" / name).read_bytes() == (JAX_PKG / "circom" / name).read_bytes()


def test_spartan_copy_differs_only_in_its_msm_route():
    """``_msm`` goes to the port's native Pippenger; the JAX package's
    ``_msm_host`` reaches the same C++ Pippenger (and a Python one only when
    the library is absent, where the port raises)."""
    changed = _differing_lines("models/spartan.py")
    assert [line.strip() for _, ours in changed for line in ours] == [
        '"""Host MSM via the port\'s native C++ Pippenger (``native.g1_msm``),',
        "built with g++ on first use.\"\"\"",
        "from .. import native",
        "return native.g1_msm(points, [s % P for s in scalars])",
    ]
    assert [line.strip() for theirs, _ in changed for line in theirs] == [
        '"""Host MSM via the native C++ Pippenger when built (msm._msm_host),',
        "pure-Python fallback otherwise.\"\"\"",
        "from ..ops.msm import _msm_host",
        "return _msm_host(points, scalars)",
    ]


def test_spartan_msm_equals_the_jax_route():
    from circuits_halo2_tpu.models import spartan as JSP
    from circuits_halo2_tpu_torch.models import nova_fold as NF
    from circuits_halo2_tpu_torch.models import spartan as SP

    bases = NF.pedersen_bases(40)
    rng = np.random.default_rng(1)
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(40)]  # some >= r
    scalars[5] = 0
    got = SP._msm(bases, scalars)
    assert got == JSP._msm(bases, scalars)
    assert got == TC.g1_msm_pippenger(bases, [s % TF.FR_MOD for s in scalars])


def test_fieldcc_copy_has_the_same_code():
    """The copy's code is the original's up to the port's own section at
    its end (the MstInclusion witness fill), apart from the ABI version
    that section raised."""
    def code(text):
        return [line for line in text.splitlines() if not line.lstrip().startswith("//")]

    shared, own = (PORT / "csrc" / "fieldcc.cpp").read_text().split(
        "// Port only, from here to the end")
    abi = 'extern "C" int fieldcc_abi_version() {{ return {}; }}'
    assert 'extern "C" int mst_witness_fill(' in own
    assert [abi.format(5) if line == abi.format(6) else line for line in code(shared)] == \
        code((JAX_PKG / "native" / "fieldcc.cpp").read_text())


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
