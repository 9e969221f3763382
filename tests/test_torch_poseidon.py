"""K1's plain torch sponge against the JAX package: ``poseidon_fast.hash_many15``
and the host ``poseidon.hash_n``, at the tree's message lengths L = 2, 3, 4.
Tolerance: exact (field elements)."""

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
