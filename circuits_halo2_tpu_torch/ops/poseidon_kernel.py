"""K1: the batched Poseidon sponge -- hand-written CUDA kernel and its plain
torch version.

Counterpart of ``circuits_halo2_tpu/ops/poseidon_pallas2.py::hash_batch_pallas2``.
``hash_batch`` takes ``(L, 16, N)`` int64 canonical Montgomery limbs (R =
2^256) and returns the ``(16, N)`` canonical Montgomery digests of the N
ConstantLength<L> messages. A CPU tensor runs ``hash_batch_ref``; a CUDA
tensor launches ``csrc/poseidon.cu`` (or raises); nothing falls back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from circuits_halo2_tpu.ops import field as F

from .. import build
from . import field_torch as FT
from . import poseidon as PS


def _mont(x: int) -> int:
    return ((x % F.FR_MOD) << 256) % F.FR_MOD


def capacity(length: int) -> int:
    """The sponge's initial capacity word L·2^64 (canonical, not Montgomery)."""
    return (length << 64) % F.FR_MOD


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_tables(device: str):
    rc = torch.tensor(
        np.stack([FT.ints_to_limbs([_mont(c) for c in row]) for row in PS.ROUND_CONSTANTS]),
        device=device,
    )  # (64, 16, 2)
    mds = torch.tensor(
        np.stack([FT.ints_to_limbs([_mont(c) for c in row]) for row in PS.MDS]),
        device=device,
    )  # (2, 16, 2)
    return rc, mds


def permute_ref(s0: torch.Tensor, s1: torch.Tensor):
    """Batched permutation on (16, N) Montgomery limbs."""
    rc, mds = _ref_tables(str(s0.device))
    for r in range(PS.N_ROUNDS):
        full = r < PS.R_FULL // 2 or r >= PS.R_FULL // 2 + PS.R_PARTIAL
        s0 = FT.pow5(FT.add_mod(s0, rc[r, :, 0:1]))
        s1 = FT.add_mod(s1, rc[r, :, 1:2])
        if full:
            s1 = FT.pow5(s1)
        n0 = FT.add_mod(FT.mont_mul(s0, mds[0, :, 0:1]), FT.mont_mul(s1, mds[0, :, 1:2]))
        n1 = FT.add_mod(FT.mont_mul(s0, mds[1, :, 0:1]), FT.mont_mul(s1, mds[1, :, 1:2]))
        s0, s1 = n0, n1
    return s0, s1


def hash_batch_ref(inputs: torch.Tensor) -> torch.Tensor:
    """The same sponge on torch limb tensors (field_torch)."""
    length, _, n = inputs.shape
    s0 = torch.zeros((FT.NLIMBS, n), dtype=FT.DTYPE, device=inputs.device)
    cap = FT.const_tensor(FT.int_to_limbs(_mont(capacity(length))), inputs.device, 2)
    s1 = cap.expand(FT.NLIMBS, n).clone()
    for i in range(length):
        s0, s1 = permute_ref(FT.add_mod(s0, inputs[i]), s1)
    return s0


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_lib():
    lib = build.cuda_library()
    words = lambda xs: FT.limbs_to_words(torch.tensor(FT.ints_to_limbs(xs)), 0)
    rc = words([_mont(c) for row in PS.ROUND_CONSTANTS for c in row])  # (8, 128)
    mds = words([_mont(c) for row in PS.MDS for c in row])             # (8, 4)
    rc_np = np.ascontiguousarray(rc.numpy().T)    # (64*2, 8) = [64][2][8]
    mds_np = np.ascontiguousarray(mds.numpy().T)  # (2*2, 8) = [2][2][8]
    build.check(lib.poseidon_set_constants(rc_np.ctypes.data, mds_np.ctypes.data),
                "poseidon_set_constants")
    return lib


def hash_batch(inputs: torch.Tensor) -> torch.Tensor:
    """(L, 16, N) Montgomery limbs -> (16, N) Montgomery digests."""
    if inputs.dim() != 3 or inputs.shape[1] != FT.NLIMBS or inputs.dtype != FT.DTYPE:
        raise ValueError(f"hash_batch wants (L, 16, N) int64, got {tuple(inputs.shape)} {inputs.dtype}")
    if inputs.device.type == "cpu":
        return hash_batch_ref(inputs)
    if inputs.device.type != "cuda":
        raise ValueError(f"hash_batch: unsupported device {inputs.device}")
    lib = _kernel_lib()
    length, _, n = inputs.shape
    words = FT.limbs_to_words(inputs, 1)  # (L, 8, N) int32, contiguous
    out = torch.empty((8, n), dtype=torch.int32, device=inputs.device)
    cap = FT.limbs_to_words(torch.tensor(FT.int_to_limbs(_mont(capacity(length)))).reshape(16, 1), 0)
    cap_np = np.ascontiguousarray(cap.numpy().reshape(8))
    stream = torch.cuda.current_stream(inputs.device).cuda_stream
    hash_batch.launches += 1
    build.check(
        lib.poseidon_hash_batch_cuda(words.data_ptr(), out.data_ptr(), length, n,
                                     cap_np.ctypes.data, stream),
        "poseidon_hash_batch_cuda",
    )
    return FT.words_to_limbs(out, 0)


hash_batch.launches = 0
