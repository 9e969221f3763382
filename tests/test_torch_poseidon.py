"""K1's plain torch sponge against the JAX package: ``poseidon_fast.hash_many15``
and the host ``poseidon.hash_n``, at the tree's message lengths L = 2, 3, 4;
and K2's plain permutation against the host ``poseidon.permute``, with the
identity that ties K2 to K1. Tolerance: exact (field elements)."""

import numpy as np
import pytest
import torch

from circuits_halo2_tpu.ops import field as F
from circuits_halo2_tpu.ops import poseidon as JP
from circuits_halo2_tpu.ops import poseidon_fast as PF
from circuits_halo2_tpu_torch.ops import field_torch as FT
from circuits_halo2_tpu_torch.ops import poseidon as TP
from circuits_halo2_tpu_torch.ops import poseidon_kernel as PK

torch.set_num_threads(2)


def _msgs(length: int, n: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    out = [[int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(length)]
           for _ in range(n)]
    out[0] = [0] * length
    out[-1] = [F.FR_MOD - 1] * length
    return out


def _limbs(msgs) -> torch.Tensor:
    length = len(msgs[0])
    return torch.stack([torch.as_tensor(FT.to_mont_limbs([m[i] for m in msgs]))
                        for i in range(length)])


def test_constants_are_the_reference_constants():
    assert TP.ROUND_CONSTANTS == JP.ROUND_CONSTANTS
    assert TP.MDS == JP.MDS and TP.MDS_INV == JP.MDS_INV


@pytest.mark.parametrize("length", [2, 3, 4])
def test_hash_batch_ref_matches_jax(length):
    msgs = _msgs(length, 6, seed=length)
    got = FT.from_mont_ints(PK.hash_batch_ref(_limbs(msgs)))
    assert got == PF.hash_many15(msgs)
    assert got == [JP.hash_n(m) for m in msgs]


@pytest.mark.parametrize("length", [2, 3, 4])
def test_host_hash_matches_jax(length):
    msgs = _msgs(length, 3, seed=10 + length)
    want = [JP.hash_n(m) for m in msgs]
    assert [TP.hash_n(m) for m in msgs] == want
    assert [TP.hash_n_py(m) for m in msgs] == want
    assert TP.permute([msgs[1][0], msgs[1][1]]) == JP.permute([msgs[1][0], msgs[1][1]])


def test_hash_batch_dispatches_to_plain_on_cpu():
    msgs = _msgs(3, 4, seed=99)
    inp = _limbs(msgs)
    assert torch.equal(PK.hash_batch(inp), PK.hash_batch_ref(inp))
    with pytest.raises(ValueError):
        PK.hash_batch(inp[:, :8])  # not (L, 16, N)


@pytest.mark.slow
def test_matches_pallas_kernel_interpret():
    """Against the TPU kernel itself, run in Pallas interpret mode on CPU."""
    from circuits_halo2_tpu.ops import poseidon_pallas2 as PP2

    for length in (3, 4):
        msgs = _msgs(length, 2, seed=length)
        assert FT.from_mont_ints(PK.hash_batch_ref(_limbs(msgs))) == PP2.hash_many_pallas2(msgs)


def test_permute_ref_matches_jax_host_permute():
    """K2's plain version: (16, N) Montgomery limbs, 0 and p - 1 included."""
    rng = np.random.default_rng(21)
    n = 6
    s0 = [int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(n)]
    s1 = [int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(n)]
    s0[0], s1[0], s0[1], s1[1] = 0, 0, F.FR_MOD - 1, F.FR_MOD - 1
    a, b = (torch.as_tensor(FT.to_mont_limbs(v)) for v in (s0, s1))
    o0, o1 = PK.permute(a, b)
    assert torch.equal(o0, PK.permute_ref(a, b)[0])
    want = [JP.permute([x, y]) for x, y in zip(s0, s1)]
    assert FT.from_mont_ints(o0) == [w[0] for w in want]
    assert FT.from_mont_ints(o1) == [w[1] for w in want]


def test_permute_with_capacity_one_is_the_l1_sponge():
    """permute(x, cap(1))[0] equals K1's ``hash_batch`` at L = 1."""
    msgs = _msgs(1, 5, seed=22)
    x = _limbs(msgs)[0]
    cap = torch.as_tensor(FT.to_mont_limbs([1 << 64] * 5))
    assert torch.equal(PK.permute(x, cap)[0], PK.hash_batch(x[None]))
    assert FT.from_mont_ints(PK.hash_batch(x[None])) == [JP.hash_n(m) for m in msgs]


def test_permute_checks_its_arguments():
    a = torch.zeros((16, 4), dtype=FT.DTYPE)
    with pytest.raises(ValueError):
        PK.permute(a, a[:, :3])
    with pytest.raises(ValueError):
        PK.permute(a[:8], a[:8])


@pytest.mark.slow
def test_permute_matches_pallas_kernel_interpret():
    """K2 against ``permute_tiles`` itself (R = 2^255 limbs), interpret mode."""
    from circuits_halo2_tpu.ops import poseidon_pallas2 as PP2

    n = PP2.SUB * PP2.LANE
    rng = np.random.default_rng(23)
    s0 = [int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(n)]
    s1 = [int.from_bytes(rng.bytes(32), "little") % F.FR_MOD for _ in range(n)]
    s0[0], s1[1] = 0, F.FR_MOD - 1

    def tiles(vals):
        limbs = PF.ints_to_limbs15([v * PF.R15 % F.FR_MOD for v in vals])
        return limbs.reshape(PP2.NL, PP2.SUB, PP2.LANE)

    j0, j1 = PP2.permute_tiles(tiles(s0), tiles(s1))
    o0, o1 = PK.permute(*(torch.as_tensor(FT.to_mont_limbs(v)) for v in (s0, s1)))
    for jo, to in ((j0, o0), (j1, o1)):
        want = [v * PF.R15_INV % F.FR_MOD for v in PF.limbs15_to_ints(np.asarray(jo).reshape(PP2.NL, n))]
        assert FT.from_mont_ints(to) == want
