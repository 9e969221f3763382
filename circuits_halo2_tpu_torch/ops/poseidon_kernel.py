"""K1 and K2: the batched Poseidon sponge and the bare permutation --
hand-written CUDA kernels and their plain torch versions.

Counterparts of ``poseidon_pallas2.py::hash_batch_pallas2`` (K1) and
``::permute_tiles`` (K2) in the JAX package. ``hash_batch`` takes
``(L, 16, N)`` int64 canonical Montgomery limbs (R = 2^256) and returns the
``(16, N)`` canonical Montgomery digests of the N ConstantLength<L>
messages; ``permute`` takes two ``(16, N)`` such tensors (s0, s1) and
returns the permuted pair. A CPU tensor runs the plain version
(``hash_batch_ref`` / ``permute_ref``); a CUDA tensor launches
``csrc/poseidon.cu`` (or raises); nothing falls back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from . import field_torch as FT
from . import poseidon as PS
from .. import build


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


@FT.plain_version
def permute_ref(s0: torch.Tensor, s1: torch.Tensor):
    """Batched permutation on (16, N) canonical Montgomery limbs."""
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


@FT.plain_version
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


def permute(s0: torch.Tensor, s1: torch.Tensor):
    """(16, N), (16, N) Montgomery limbs -> the permuted (s0, s1)."""
    for x in (s0, s1):
        if x.dim() != 2 or x.shape[0] != FT.NLIMBS or x.dtype != FT.DTYPE:
            raise ValueError(f"permute wants (16, N) int64, got {tuple(x.shape)} {x.dtype}")
    if s0.shape != s1.shape or s0.device != s1.device:
        raise ValueError("permute: s0 and s1 differ in shape or device")
    if s0.device.type == "cpu":
        return permute_ref(s0, s1)
    if s0.device.type != "cuda":
        raise ValueError(f"permute: unsupported device {s0.device}")
    lib = _kernel_lib()
    n = s0.shape[1]
    w0, w1 = FT.limbs_to_words(s0, 0), FT.limbs_to_words(s1, 0)
    o0, o1 = torch.empty_like(w0), torch.empty_like(w1)
    stream = torch.cuda.current_stream(s0.device).cuda_stream
    permute.launches += 1
    build.check(lib.poseidon_permute_cuda(w0.data_ptr(), w1.data_ptr(), o0.data_ptr(),
                                          o1.data_ptr(), n, stream),
                "poseidon_permute_cuda")
    return FT.words_to_limbs(o0, 0), FT.words_to_limbs(o1, 0)


permute.launches = 0
