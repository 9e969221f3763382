"""A mesh proof of the port on the CPU: a 2-rank gloo world (launched once
through ``parallel/worker.launch``; the ranks import only the port) runs
keygen and the Keccak proof of entry_16 user 0 at k=11 with the mesh set,
so keygen's and the prover's MSMs of 2048 lanes and the extended domain's
NTTs go through ``parallel/{msm,ntt}_sharded``. The VK equals
tests/fixtures_vk_inclusion.json and the proof equals the JAX package's
bytes (tests/fixtures_torch_proofs.json) on both ranks, verifies, and a
flipped byte is rejected: the counterpart of
``tests/test_e2e_prove.py::test_mesh_prove_bit_identical`` and of
``tests/mh_worker.py``'s "prove" mode. Exact. Its own file, so that
``--dist loadfile`` gives it a worker of its own."""

import json
from pathlib import Path

import pytest

from circuits_halo2_tpu_torch.parallel import worker

HERE = Path(__file__).resolve().parent
FIX = json.loads((HERE / "fixtures_torch_proofs.json").read_text())
VK_FIX = json.loads((HERE / "fixtures_vk_inclusion.json").read_text())
WORLD = 2


@pytest.fixture(scope="module")
def ranks():
    return worker.launch(WORLD, "gloo", "cpu", f"{HERE / 'torch_parallel_tasks.py'}:prove_entry16",
                         timeout=900, threads=2)


def _points(rows):
    return [(int(x, 16), int(y, 16)) for x, y in rows]


def test_mesh_vk_equals_the_fixture(ranks):
    for r in ranks:
        assert _points(r["fixed"]) == _points(VK_FIX["fixed_comms"])
        assert _points(r["permutation"]) == _points(VK_FIX["permutation_comms"])
        assert int(r["transcript_repr"], 16) == int(VK_FIX["vk_digest"], 16)


def test_mesh_proof_equals_the_jax_bytes_on_every_rank(ranks):
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    for r in ranks:
        assert r["proof"] == FIX["keccak_vk_digest_proof"]


def test_mesh_proof_verifies_and_a_flipped_byte_does_not(ranks):
    for r in ranks:
        assert r["verifies"] and r["flipped_rejected"]


def test_the_seams_sharded(ranks):
    """Keygen's fixed and sigma commitments and the prover's commitments
    (2048 lanes, 1024 a rank) and the extended domain's transforms
    (2^13 >= 2^12 points) went through the mesh."""
    for r in ranks:
        assert r["sharded"]["msm"] > 0 and r["sharded"]["ntt"] > 0
        assert r["collectives"]["all_gather"] > 0 and r["collectives"]["all_to_all"] > 0
