"""The CUDA kernels on the card: K1, K2, K3, K4, the K5/K6 probes and X4 (the
EC-FFT) against their plain torch versions at ragged and main-path shapes,
the device tree and the Pippenger on the card against the same code on the
CPU and the native host code, X4's Lagrange bases against the analytic
ones, and the incremental step chain on the card against the JAX package's
bytes. Exact (field elements; exact u32 for ``bcast``).

Every test is marked ``cuda`` and skips without a CUDA device (the kernels
have no CPU mode). The file imports no JAX, so it runs where JAX is absent:

    CIRCUITS_TPU_NO_CACHE=1 python -m pytest tests/test_torch_cuda.py -o addopts="" -m cuda -q
"""

import numpy as np
import pytest
import torch

from circuits_halo2_tpu_torch import native
from circuits_halo2_tpu_torch.merkle import device_tree as TDT
from circuits_halo2_tpu_torch.ops import ec_fft_kernel as EK
from circuits_halo2_tpu_torch.ops import field as F
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import msm as TM
from circuits_halo2_tpu_torch.ops import msm_kernel as MK
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK
from circuits_halo2_tpu_torch.ops import poseidon_mxu as PM
from circuits_halo2_tpu_torch.scripts import exp_poseidon_mxu as EXP
from circuits_halo2_tpu_torch.utils import ec_fft as EC
from circuits_halo2_tpu_torch.utils.srs import ParamsKZG

torch.set_num_threads(2)

G1_GEN = (1, 2)
FR_MOD, FQ_MOD = FT.FR.mod_int, FT.FQ.mod_int


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _fr(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("length", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 3000, 1 << 13])  # one message, a ragged block, a small level
def test_k1_matches_plain(dev, length, n):
    rng = np.random.default_rng(length * n)
    cols = [_fr(rng, n) for _ in range(length)]
    cols[0][0] = 0
    cols[-1][-1] = FR_MOD - 1
    inp = torch.stack([torch.as_tensor(FT.to_mont_limbs(c), device=dev) for c in cols])
    before = PK.hash_batch.launches
    got = PK.hash_batch(inp)
    assert PK.hash_batch.launches == before + 1
    assert got.device == inp.device and got.shape == (16, n)
    assert torch.equal(got, PK.hash_batch_ref(inp))
    assert FT.from_mont_ints(got[:, :8]) == native.poseidon_hash_batch(
        [[c[i] for c in cols] for i in range(min(n, 8))], length)


def _scan_inputs(dev, n, B, W, seed):
    """Digit-sorted K3 inputs with invalid points, repeats (doubling) and
    P + (-P) inside buckets."""
    rng = np.random.default_rng(seed)
    base = native.g1_fixed_base_muls(G1_GEN, [int(v) for v in rng.integers(1, 10**9, 6)])
    pts = [base[i] for i in rng.integers(0, 6, n)]
    pts[10] = (pts[9][0], FQ_MOD - pts[9][1])
    xs = torch.as_tensor(FT.to_mont_limbs([p[0] for p in pts], FT.FQ), device=dev)
    ys = torch.as_tensor(FT.to_mont_limbs([p[1] for p in pts], FT.FQ), device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[[5, n // 2 + 1]] = False
    digits = torch.as_tensor(np.sort(rng.integers(0, 3, (B, W, n)), axis=-1), device=dev)
    px = xs[:, None, None, :].expand(16, B, W, n).contiguous()
    py = ys[:, None, None, :].expand(16, B, W, n).contiguous()
    return px, py, valid.expand(B, W, n).contiguous(), digits


def _pippenger_inputs(dev, n, B, zeros, seed):
    """What the Pippenger hands K3 for B columns of random scalars, a share
    ``zeros`` of them 0: the bases gathered in sorted window-digit order."""
    rng = np.random.default_rng(seed)
    points = native.g1_fixed_base_muls(G1_GEN, _fr(rng, n))
    points[3] = None
    rows = [[0 if z else v for v, z in zip(_fr(rng, n), rng.random(n) < zeros)]
            for _ in range(B)]
    scal = torch.as_tensor(FT.to_mont_limbs([v for r in rows for v in r]).reshape(16, B, n),
                           device=dev)
    xs, ys, valid = TM.precompute_bases(points, dev)
    digits = TM.digits_from_mont(scal)
    perm = torch.argsort(digits, dim=-1, stable=True)
    pxy = torch.cat([xs, ys], dim=0)[:, perm]
    return pxy[:16], pxy[16:], valid[perm], torch.gather(digits, -1, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,W,zeros", [
    (256, 2, 4, None), (2048, 1, 32, None),  # crafted digits 0-2
    (1 << 13, 16, TM.NWIN, 0.0),  # k=13, a keygen batch of 16 columns
    (1 << 13, 3, TM.NWIN, 0.9),  # k=13, skewed digits: 90 % zero scalars
    (1 << 14, 3, TM.NWIN, 0.9),  # k=14 (L=256), skewed digits
])
def test_k3_matches_plain(dev, n, B, W, zeros):
    if zeros is None:
        px, py, pv, digits = _scan_inputs(dev, n, B, W, seed=n)
    else:
        px, py, pv, digits = _pippenger_inputs(dev, n, B, zeros, seed=n + B)
    assert digits.shape == (B, W, n)
    L = TM._seg_chunk_len(n)
    before = MK.segmented_scan.launches
    got = MK.segmented_scan(px, py, pv, digits, L)
    assert MK.segmented_scan.launches == before + 1
    want = MK.segmented_scan_ref(px, py, pv, digits, L)
    for g, w in zip(got, want):
        assert g.device == px.device and torch.equal(g, w)


@pytest.mark.cuda
def test_device_tree_matches_cpu(dev):
    """Depth 7 with near-u64 balances: every level equal on the card and the CPU."""
    rng = np.random.default_rng(7)
    n = 1 << 7
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    balances = rng.integers(1 << 63, 1 << 64, size=(n, 2), dtype=np.uint64)
    card = TDT.build_device_tree(digests, balances, dev)
    host = TDT.build_device_tree(digests, balances, "cpu")
    assert card.root() == host.root()
    for a, b in zip(card.level_hashes + card.level_balances,
                    host.level_hashes + host.level_balances):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_msm_commit_dev_matches_native(dev):
    rng = np.random.default_rng(11)
    n = 1 << 11
    points = native.g1_fixed_base_muls(G1_GEN, _fr(rng, n))
    points[3] = None
    points[7] = (points[6][0], FQ_MOD - points[6][1])
    rows = [_fr(rng, n) for _ in range(3)]
    rows[0][0], rows[0][1] = 0, FR_MOD - 1
    rows[0][6] = rows[0][7]
    rows[1] = [0] * n
    want = [native.g1_msm(points, r) for r in rows]
    assert TM.msm_auto_batch(points, rows, dev) == want
    assert TM.msm_auto_batch(points, rows, "cpu") == want


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3000])
def test_k2_matches_plain_and_k1(dev, n):
    rng = np.random.default_rng(n + 1)
    s0, s1 = _fr(rng, n), _fr(rng, n)
    s0[0], s1[-1] = 0, FR_MOD - 1
    a = torch.as_tensor(FT.to_mont_limbs(s0), device=dev)
    b = torch.as_tensor(FT.to_mont_limbs(s1), device=dev)
    before = PK.permute.launches
    got = PK.permute(a, b)
    assert PK.permute.launches == before + 1
    for g, w in zip(got, PK.permute_ref(a, b)):
        assert g.device == a.device and torch.equal(g, w)
    cap = torch.as_tensor(FT.to_mont_limbs([1 << 64] * n), device=dev)
    assert torch.equal(PK.permute(a, cap)[0], PK.hash_batch(a[None]))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 3000])
def test_k4_matches_plain_and_host(dev, length, n):
    rng = np.random.default_rng(length * n + 5)
    cols = [[int.from_bytes(rng.bytes(32), "little") for _ in range(n)] for _ in range(length)]
    for c in cols:
        c[0] = 0
        c[-1] = (1 << 256) - 1
    if n > 1:
        for c in cols:
            c[1] = FR_MOD - 1
    inp = torch.stack([torch.as_tensor(FT.ints_to_limbs(c), device=dev) for c in cols])
    before = PM.hash_batch_mxu.launches
    got = PM.hash_batch_mxu(inp)
    assert PM.hash_batch_mxu.launches == before + 1
    assert got.device == inp.device and got.shape == (16, n)
    assert torch.equal(got, PM.hash_batch_mxu_ref(inp))
    msgs = [[c[i] % FR_MOD for c in cols] for i in range(min(n, 8))]
    assert FT.limbs_to_ints(got[:, :8]) == native.poseidon_hash_batch(msgs, length)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["vpu_mul", "boundary", "mxu_mul", "bcast"])
def test_k5_matches_plain(dev, variant):
    x, y = EXP.make_inputs(variant, 1000, 3, dev)
    before = EXP.run.launches
    got = EXP.run(variant, x, y, 7)
    assert EXP.run.launches == before + 1
    assert torch.equal(got, EXP.run_ref(variant, x, y, 7))


@pytest.mark.cuda
def test_k6_check(dev):
    before = EXP.mxu_mul_once.launches
    assert EXP.check_mxu_mul_exact(dev) == 0
    assert EXP.mxu_mul_once.launches == before + 1


@pytest.mark.cuda
def test_tree_root_mxu_matches_device_tree(dev):
    rng = np.random.default_rng(9)
    n = 1 << 7
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    balances = rng.integers(1 << 63, 1 << 64, size=(n, 2), dtype=np.uint64)
    assert TDT.tree_root_mxu(digests, balances, dev) == TDT.build_device_tree(
        digests, balances, dev).root()


@pytest.mark.cuda
def test_x4_matches_plain(dev):
    """n = 2 with an infinity lane, forward and scaled inverse as a batch of
    two: one stage launch and one scale launch, equal to the plain version."""
    points = [None, native.g1_fixed_base_muls(G1_GEN, [12345])[0]]
    args = EC.transform_inputs(points, [(FR_MOD - 1, 1), (FR_MOD - 1, F.fr_inv(2))], dev)
    before = EK.ec_fft.launches
    got = EK.ec_fft(*args)
    assert EK.ec_fft.launches == before + 2
    for g, w in zip(got, EK.ec_fft_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 11])
def test_x4_lagrange_bases_match_analytic(dev, k):
    """``g_to_lagrange`` through X4 (2^k >= DEVICE_MIN) gives the setup's
    analytic Lagrange bases."""
    params = ParamsKZG.setup(k)
    assert EC.g_to_lagrange(params.g, k, dev) == params.g_lagrange


@pytest.mark.cuda
def test_incremental_chain_on_the_card_equals_jax_bytes(dev):
    """``prove_chain`` over entry_16 rounds 1-3 on the card (trees through
    K1, proofs through K3) gives the JAX package's step proofs
    (tests/fixtures_torch_incremental.json, part ``steps``)."""
    import json
    from pathlib import Path

    from circuits_halo2_tpu_torch.models import incremental as INC
    from circuits_halo2_tpu_torch.utils import pipeline

    here = Path(__file__).parent
    fix = json.loads((here / "fixtures_torch_incremental.json").read_text())["steps"]
    art = pipeline.generate_incremental_artifacts(
        fix["k"], str(here / fix["ptau"]), fix["levels"], fix["n_currencies"], fix["n_bytes"],
        device=dev)
    k1, k3 = PK.hash_batch.launches, MK.segmented_scan.launches
    chain = INC.prove_chain(art, [str(here / p) for p in fix["csvs"]], fix["user_index"])
    assert PK.hash_batch.launches > k1 and MK.segmented_scan.launches > k3
    assert [s.proof.hex() for s in chain.steps] == fix["proofs"]
    assert [hex(v) for v in chain.liab_states] == fix["liab_states"]
    assert INC.verify_chain(art, chain)
