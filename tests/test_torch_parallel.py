"""The port's rank mesh (``circuits_halo2_tpu_torch/parallel``) against the
JAX package's references, the ones its tests hold ``parallel/*`` to.

One 4-rank gloo world on the CPU, launched once for the module through
``parallel/worker.launch``, runs ``tests/torch_parallel_tasks.py::kernels``
(the ranks import only the port); this process compares what every rank
returns with the JAX package's host functions on the same seeded inputs:
``ops/ntt.ntt_host``, ``ops/curve.g1_msm_pippenger`` and
``merkle/mst.build_merkle_tree_from_leaves`` (the counterparts of
``tests/test_sharded_ops.py``, ``tests/test_sharded_prover.py:70,103`` and
``tests/mh_worker.py:87-103``; the JAX package's shard_map functions are
not run here). The policy (``parallel/auto``), the seams' routing
conditions and ``prove_batch``'s suspension run in this process. Exact.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from circuits_halo2_tpu.merkle import mst as jax_mst
from circuits_halo2_tpu.ops import curve as C
from circuits_halo2_tpu.ops import ntt as JNTT
from circuits_halo2_tpu_torch.models import prover_batch
from circuits_halo2_tpu_torch.ops import msm as M
from circuits_halo2_tpu_torch.ops import ntt as NTT
from circuits_halo2_tpu_torch.parallel import auto, worker

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_tasks as T  # noqa: E402

torch.set_num_threads(2)

TASKS = str(Path(T.__file__).resolve())
WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return worker.launch(WORLD, "gloo", "cpu", f"{TASKS}:kernels", timeout=600, threads=1)


def _ints(hexes):
    return [int(h, 16) for h in hexes]


def _pt(p):
    return None if p is None else tuple(_ints(p))


def test_every_rank_returns_the_same_values(ranks):
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert all(r["size"] == WORLD for r in ranks)
    first = {k: v for k, v in ranks[0].items() if k != "rank"}
    for r in ranks[1:]:
        assert {k: v for k, v in r.items() if k != "rank"} == first


def test_ntt_sharded_host_matches_jax_ntt_host(ranks):
    want = JNTT.ntt_host(T.fr_values(1, 1 << 10), JNTT.omega_for_k(10))
    assert _ints(ranks[0]["ntt_1024"]) == want


def test_ntt_sharded_roundtrip(ranks):
    assert ranks[0]["roundtrip_ok"]


def test_ntt_sharded_batched_matches_single_device(ranks):
    assert ranks[0]["ntt_batched_equal"]


def test_msm_sharded_matches_jax_pippenger(ranks):
    points, rows = T.msm_inputs()
    got = [_pt(p) for p in ranks[0]["msm"]]
    assert got[0] == C.g1_msm_pippenger(points, rows[0])
    assert got[1] is None


def test_commit_under_the_mesh_matches_single_device_and_host(ranks):
    points, scal = T.commit_inputs()
    r = ranks[0]
    assert r["commit_routed"] == 1
    assert _pt(r["commit_mesh"]) == _pt(r["commit_single"]) == C.g1_msm_pippenger(points, scal)
    assert r["msm_device"] == r["commit_mesh"]  # the same lanes as digits


def test_sharded_tree_matches_jax_mst(ranks):
    pre = T.tree_inputs()
    nodes = [jax_mst.Node.leaf_node_from_preimage(list(p)) for p in pre]
    root, levels = jax_mst.build_merkle_tree_from_leaves(nodes, 4)
    r = ranks[0]
    assert _ints(r["leaves"]) == [n.hash for n in nodes]
    assert _ints(r["level1"][0]) == [n.hash for n in levels[1]]
    assert [_ints(b) for b in r["level1"][1]] == [[n.balances[c] for n in levels[1]]
                                                  for c in range(2)]
    assert int(r["root"][0], 16) == root.hash
    assert _ints(r["root"][1]) == root.balances


def test_each_sharded_function_ran_over_the_mesh(ranks):
    r = ranks[0]
    assert r["sharded"] == {"ntt": 4, "msm": 3, "hash": 1, "tree": 2}
    assert r["collectives"]["all_to_all"] == 4 and r["collectives"]["all_gather"] > 0


# --- in this process: the policy, the seams' conditions, the suspension -----

@pytest.mark.parametrize("mode,size,backend,want", [
    ("1", 1, "gloo", True), ("1", 4, "gloo", True), ("1", 2, "nccl", True),
    ("0", 4, "nccl", False), ("0", 1, "gloo", False),
    ("auto", 4, "nccl", True), ("auto", 1, "nccl", False), ("auto", 4, "gloo", False),
])
def test_policy(mode, size, backend, want):
    assert auto.shards(mode, size, backend) is want


def test_policy_rejects_an_unknown_mode():
    with pytest.raises(ValueError):
        auto.shards("2", 4, "nccl")


@pytest.fixture
def no_override():
    auto.clear_mesh()
    yield
    auto.clear_mesh()


def test_set_get_clear_and_ndev(no_override, monkeypatch):
    monkeypatch.setenv("CIRCUITS_TPU_SHARD", "1")
    assert auto.get_mesh() is None and auto.ndev() == 1  # no process group
    mesh = SimpleNamespace(size=3)
    auto.set_mesh(mesh)
    assert auto.get_mesh() is mesh and auto.ndev() == 3
    auto.set_mesh(None)
    assert auto.get_mesh() is None and auto.ndev() == 1
    auto.clear_mesh()
    assert auto.get_mesh() is None


def test_env_policy_over_an_initialised_group(no_override, monkeypatch):
    """A 1-rank gloo group in this process: ``1`` shards over it (on the
    card: one is pretended), ``auto`` and ``0`` do not (gloo is opt-in)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        monkeypatch.setenv("CIRCUITS_TPU_SHARD", "1")
        mesh = auto.get_mesh()
        assert mesh is not None and (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        assert mesh.device == torch.device("cuda", 0)
        assert auto.get_mesh() is mesh
        for mode in ("auto", "0"):
            monkeypatch.setenv("CIRCUITS_TPU_SHARD", mode)
            assert auto.get_mesh() is None
    finally:
        dist.destroy_process_group()


def test_seams_route_only_where_the_jax_package_does(no_override):
    def mesh_of(size):
        auto.set_mesh(SimpleNamespace(size=size))
        return auto.get_mesh()

    m = mesh_of(4)
    assert M._active_mesh(1 << 10) is m and M._active_mesh(1 << 13) is m
    assert M._active_mesh(1 << 9) is None  # 128 lanes a rank
    assert NTT._shard_mesh(1 << 12) is m and NTT._shard_mesh(1 << 15) is m
    assert NTT._shard_mesh(1 << 11) is None  # below the threshold
    m = mesh_of(3)
    assert M._active_mesh(1 << 13) is None and NTT._shard_mesh(1 << 13) is None
    m = mesh_of(128)
    assert NTT._shard_mesh(1 << 13) is None  # n < size^2
    assert NTT._shard_mesh(1 << 14) is m
    auto.set_mesh(None)
    assert M._active_mesh(1 << 13) is None and NTT._shard_mesh(1 << 15) is None


def test_prove_batch_suspends_and_restores_the_mesh(no_override, monkeypatch):
    mesh = SimpleNamespace(size=2)
    seen = []

    def fake_prove_users(*args):
        seen.append(auto.get_mesh())
        if len(seen) == 2:
            raise RuntimeError("inside the batch")
        return [b""]

    monkeypatch.setattr(prover_batch, "prove_users", fake_prove_users)
    auto.set_mesh(mesh)
    assert prover_batch.prove_batch(None, None, [object()], None, [[]]) == [b""]
    assert seen == [None] and auto.get_mesh() is mesh
    with pytest.raises(RuntimeError):
        prover_batch.prove_batch(None, None, [object()], None, [[]])
    assert seen == [None, None] and auto.get_mesh() is mesh


def test_a_failed_rank_raises_its_traceback():
    with pytest.raises(RuntimeError, match="ValueError: rank 1 fails"):
        worker.launch(2, "gloo", "cpu", f"{TASKS}:fail_on_rank_1", timeout=120, threads=1)
