"""Number-theoretic transform over the rank mesh
(``circuits_halo2_tpu/parallel/ntt_sharded.py`` on ``torch.distributed``).

The four-step (Bailey) decomposition n = n1·n2, the input a row-major
n1 x n2 matrix a[j1·n2 + j2], each rank holding a block of its columns:

    A[k1 + n1·k2] = sum_{j2} w^{j2·k1} · (w^{n1})^{j2·k2}
                    · sum_{j1} a[j1·n2 + j2] · (w^{n2})^{j1·k1}

1. length-n1 transforms down the rank's columns, root w^{n2} (local);
2. the pointwise twiddle w^{j2·k1} (local, ``FT.mont_mul``);
3. one all-to-all: from blocks of columns (j2) to blocks of rows (k1);
4. length-n2 transforms along the rows, root w^{n1} (local).

The local transforms are the single-device ``ops/ntt._ntt_device``. In the
JAX package the result stays a sharded global array; each rank of the
port needs the whole transform, so the k1 blocks are all-gathered into
natural order. The result equals ``ops/ntt.ntt`` limb for limb. Like the
single-device NTT this is plain torch; a hand kernel for the transform is
ROADMAP X1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import field as F
from ..ops import field_torch as FT
from ..ops import ntt as NTT
from .sharding import Mesh

P = F.FR_MOD


def split(n: int, size: int) -> tuple[int, int] | None:
    """(n1, n2) of the four-step transform of n points over ``size`` ranks,
    the JAX package's split: log2(n2) = max((log2(n) + 1) // 2,
    bitlen(size - 1)); None unless n1 and n2 both split over the ranks."""
    logn = n.bit_length() - 1
    n2 = 1 << max((logn + 1) // 2, (size - 1).bit_length())
    n1 = n // n2
    if n != 1 << logn or n1 * n2 != n or n1 % size or n2 % size:
        return None
    return n1, n2


@functools.lru_cache(maxsize=16)
def _twiddle_matrix(n1: int, n2: int, omega: int) -> np.ndarray:
    """w^{j2·k1} as a (16, n1, n2) Montgomery limb array (k1 rows)."""
    vals = []
    w = 1  # w^{k1}
    for _ in range(n1):
        v = 1
        for _ in range(n2):
            vals.append(v)
            v = v * w % P
        w = w * omega % P
    return FT.to_mont_limbs(vals).reshape(FT.NLIMBS, n1, n2)


@functools.lru_cache(maxsize=16)
def _local_twiddles(n1: int, n2: int, omega: int, lo: int, hi: int, device: str) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(_twiddle_matrix(n1, n2, omega)[:, :, lo:hi]),
                           device=device)


def ntt_sharded_batched(mesh: Mesh, a: torch.Tensor, omega: int) -> torch.Tensor:
    """The transform of a (16, *batch, n) Montgomery limb tensor along its
    last axis, over the mesh; every rank returns the whole result."""
    mesh.count("ntt")
    shape = a.shape
    n = int(shape[-1])
    blocks = split(n, mesh.size)
    if blocks is None:
        raise ValueError(f"a {n}-point four-step transform does not split over {mesh.size} ranks")
    n1, n2 = blocks
    lo, hi = mesh.block(n2)
    x = a.reshape(FT.NLIMBS, -1, n1, n2)[..., lo:hi]                  # (16, b, n1, n2loc)
    x = NTT._ntt_device(x.transpose(2, 3), F.fr_pow(omega, n2))       # step 1: (16, b, n2loc, k1)
    tw = _local_twiddles(n1, n2, omega, lo, hi, str(a.device))
    x = FT.mont_mul(x.transpose(2, 3), tw[:, None])                   # step 2: (16, b, k1, n2loc)
    x = mesh.all_to_all(x, split_dim=2, concat_dim=3)                 # step 3: (16, b, k1loc, n2)
    x = NTT._ntt_device(x, F.fr_pow(omega, n1))                       # step 4: (16, b, k1loc, k2)
    g = mesh.all_gather(x)                                            # (size, 16, b, k1loc, k2)
    # flat output index k1 + n1·k2: the (k2, k1) matrix, k1 = rank block + local row
    return g.permute(1, 2, 4, 0, 3).reshape(shape)


def ntt_sharded(mesh: Mesh, a: torch.Tensor, omega: int) -> torch.Tensor:
    """The transform of a (16, n) Montgomery limb tensor over the mesh."""
    return ntt_sharded_batched(mesh, a, omega)


def ntt_sharded_host(mesh: Mesh, values: list[int], omega: int) -> list[int]:
    """Host ints in and out (tests)."""
    a = torch.as_tensor(FT.to_mont_limbs(values), device=mesh.device)
    return FT.from_mont_ints(ntt_sharded(mesh, a, omega))
