"""The Merkle sum tree of a snapshot, in plain torch and Python ints.

Written for the benchmark's reference, apart from the port: the same
semantics as ``merkle/device_tree.build_device_tree`` and ``merkle/mst``
(a leaf hashes (username digest mod r, balances...), a node above hashes
(the children's balance sums..., left hash, right hash), Poseidon
ConstantLength<L> over BN254 Fr, t = 2, 8 full and 56 partial rounds), and
no code of it. Large levels run on the card (or the CPU) as plain torch ops
on (16, n) int64 tensors of 16-bit limbs in Montgomery form (R = 2^256),
products as exact float64 matrix products;
levels of at most ``HOST_MAX`` nodes, where the torch ops would be bound by
their launches, run on the host in Python ints (``poseidon.hash_n_py``).
Balance sums are exact integers (numpy uint64, checked not to overflow).
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F
from . import poseidon as PS

P = F.FR_MOD
NL = 16
MASK = 0xFFFF
R = 1 << 256
R_INV = pow(R, -1, P)
N0 = (-pow(P, -1, 1 << 16)) % (1 << 16)  # -p^-1 mod 2^16
HOST_MAX = 1 << 9


def _limbs(x: int) -> list[int]:
    return [(x >> (16 * i)) & MASK for i in range(NL)]


def ints_from_limbs(t: torch.Tensor) -> list[int]:
    """(16, n) limb tensor -> n Python ints."""
    a = t.to("cpu").numpy().astype(object)
    out = a[0].copy()
    for i in range(1, NL):
        out = out + (a[i] << (16 * i))
    return [int(v) for v in out]


class Field:
    """Montgomery arithmetic on (16, n) int64 tensors of 16-bit limbs.

    Values are kept lazily below 3.95 p (R / p = 5.29, so a product of two
    such values reduces to below it again) and only brought below p where a
    sum could leave that range (``canon``); limbs are at most 2^17 + 1.
    Products are exact float64 matrix products: the columns of a product,
    of m = t·(-p^-1) mod R and of m·p each sum at most 32 terms below 2^43,
    inside float64's 53 bits. Carries move over all limbs at once
    (``_spread``): the op count, not the bytes, bounds plain torch here."""

    def __init__(self, device):
        self.device = torch.device(device)
        diag = np.zeros((2 * NL - 1, NL * NL))
        for i in range(NL):
            for j in range(NL):
                diag[i + j, i * NL + j] = 1
        self.diag = torch.tensor(diag, dtype=torch.float64, device=self.device)
        self.nprime = self._toeplitz(R - pow(P, -1, R), rows=NL)
        self.pmat = self._toeplitz(P)
        self.p_limbs = {k: self.const(k * P) for k in (1, 2)}
        self.r2 = self.const_matrix([R * R % P])

    def _toeplitz(self, c: int, rows: int = 2 * NL - 1) -> torch.Tensor:
        """The (rows, 16) matrix whose product with a's limbs gives the
        columns of c·a (truncated to ``rows`` columns)."""
        limbs = _limbs(c)
        m = np.zeros((rows, NL))
        for col in range(rows):
            for j in range(max(0, col - NL + 1), min(NL, col + 1)):
                m[col, j] = limbs[col - j]
        return torch.tensor(m, dtype=torch.float64, device=self.device)

    def const(self, x: int) -> torch.Tensor:
        return torch.tensor(_limbs(x), dtype=torch.int64, device=self.device).reshape(NL, 1)

    def cols(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(31, n) columns of a·b."""
        a, b = torch.broadcast_tensors(a, b)
        outer = (a.double().unsqueeze(1) * b.double().unsqueeze(0)).reshape(NL * NL, -1)
        return (self.diag @ outer).long()

    def const_matrix(self, consts: list[int]) -> torch.Tensor:
        """The matrix ``const_cols`` takes for sum_i consts[i]·a[i]."""
        return torch.cat([self._toeplitz(c) for c in consts], dim=1)

    @staticmethod
    def const_cols(a: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
        """(31, n) columns of sum_i consts[i]·a[i] for (k, 16, n) a."""
        return (matrix @ a.reshape(matrix.shape[1], -1).double()).long()

    @staticmethod
    def _spread(x: torch.Tensor, rounds: int) -> None:
        """Move each row's bits above 16 into the next row, ``rounds`` times
        over all rows at once, in place; the top row's overflow is dropped.
        The value below the top row is kept; rows end at most 2^16 once the
        rounds outnumber the carries' 16-bit digits."""
        for _ in range(rounds):
            hi = x >> 16
            x &= MASK
            x[1:] += hi[:-1]

    def redc(self, cols: torch.Tensor) -> torch.Tensor:
        """t·R^-1 mod p (lazily) of the (31, n) columns of t < 15.6 p^2.

        m = -t/p mod R comes out with limbs at most 2^16, so m < 1.0001 R
        and the result stays below 3.95 p. t + m·p is a multiple of R: after
        the rounds its low limbs are all 0 (a multiple 0) or not (R), the
        carry into limb 16."""
        t = torch.cat([cols, torch.zeros_like(cols[:2])])
        self._spread(t, 1)  # limbs below 2^23: the products below stay exact
        m = (self.nprime @ t[:NL].double()).long()
        self._spread(m, 3)  # mod R: the top row's carry is dropped
        t[:2 * NL - 1] += (self.pmat @ m.double()).long()
        self._spread(t, 3)
        out = t[NL:2 * NL].clone()
        out[0] += (t[:NL] != 0).any(dim=0)
        return out

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.redc(self.cols(a, b))

    def canon(self, x: torch.Tensor) -> torch.Tensor:
        """x < 4p -> x mod p, by two conditional subtractions (of 2p, p)."""
        for k in (2, 1):
            d = x - self.p_limbs[k]
            for i in range(NL - 1):
                d[i + 1] += d[i] >> 16
            keep = (d[NL - 1] >> 16) < 0  # x < k·p
            d &= MASK
            x = torch.where(keep.unsqueeze(0), x, d)
        return x

    def to_mont(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw limbs of a value < 2^256 -> its Montgomery form, below p."""
        return self.canon(self.redc(self.const_cols(raw.unsqueeze(0), self.r2)))


class Sponge:
    """Batched ConstantLength<L> Poseidon on Montgomery limb tensors: the
    state's words stay below 3.95 p between rounds; absorbed words and the
    digest are brought below p."""

    def __init__(self, device):
        self.f = Field(device)
        mont = lambda c: self.f.const(c * R % P)
        self.rc = [(mont(a), mont(b)) for a, b in PS.ROUND_CONSTANTS]
        self.mds = [self.f.const_matrix([c * R % P for c in row]) for row in PS.MDS]
        self.capacity = {}

    def _pow5(self, x):
        f = self.f
        x2 = f.mul(x, x)
        return f.mul(f.mul(x2, x2), x)

    def permute(self, s0, s1):
        f = self.f
        for r, (c0, c1) in enumerate(self.rc):
            full = r < PS.R_FULL // 2 or r >= PS.R_FULL // 2 + PS.R_PARTIAL
            s0 = self._pow5(s0 + c0)
            s1 = s1 + c1
            if full:
                s1 = self._pow5(s1)
            state = torch.stack([s0, s1])
            s0 = f.redc(f.const_cols(state, self.mds[0]))
            s1 = f.redc(f.const_cols(state, self.mds[1]))
        return s0, s1

    def hash(self, msgs: list[torch.Tensor]) -> torch.Tensor:
        """L (16, n) Montgomery messages below p -> (16, n) digests below p."""
        n = msgs[0].shape[1]
        s0 = torch.zeros((NL, n), dtype=torch.int64, device=self.f.device)
        if len(msgs) not in self.capacity:
            self.capacity[len(msgs)] = self.f.const(((len(msgs) << 64) % P) * R % P)
        s1 = self.capacity[len(msgs)].expand(NL, n).clone()
        for m in msgs:
            s0, s1 = self.permute(self.f.canon(s0 + m), s1)
        return self.f.canon(s0)


def u64_limbs(values: np.ndarray, device) -> torch.Tensor:
    """(n,) uint64 -> (16, n) int64 raw limbs."""
    v = np.ascontiguousarray(values.astype("<u8")).view("<u2").reshape(len(values), 4)
    out = torch.zeros((NL, len(values)), dtype=torch.int64, device=device)
    out[:4] = torch.as_tensor(v.T.astype(np.int64), device=device)
    return out


def sum_limbs(values: np.ndarray, device) -> torch.Tensor:
    """(n,) exact non-negative integers (uint64 or object) -> raw limbs."""
    if values.dtype == np.uint64:
        return u64_limbs(values, device)
    lo = np.array([int(v) & ((1 << 64) - 1) for v in values], dtype=np.uint64)
    hi = np.array([int(v) >> 64 for v in values], dtype=np.uint64)
    out = u64_limbs(lo, device)
    out[4:8] = u64_limbs(hi, device)[:4]
    return out


def digest_limbs(digests: np.ndarray, device) -> torch.Tensor:
    """(n, 32) big-endian uint8 digests -> (16, n) raw limbs of the 256-bit value."""
    le = np.ascontiguousarray(digests[:, ::-1]).view("<u2").reshape(len(digests), NL)
    return torch.as_tensor(le.T.astype(np.int64), device=device)


class Tree:
    """Every level of the tree over ``digests`` (n, 32) and ``balances``
    (n, C) uint64 (n a power of two): ``hashes[l]`` canonical ints of level l
    for host levels, a (16, n_l) Montgomery tensor for device levels;
    ``sums[l]`` the (n_l, C) exact balance sums."""

    def __init__(self, digests: np.ndarray, balances: np.ndarray, device):
        n, ncur = balances.shape
        depth = n.bit_length() - 1
        if n != 1 << depth:
            raise ValueError("entry count must be a power of two")
        top = max(int(b) for b in balances.max(axis=0)) if n else 0
        exact = top * n < 1 << 64
        sums = balances.astype(np.uint64 if exact else object)
        self.digests = digests
        self.ncur = ncur
        self.depth = depth
        self.sums = [sums]
        for _ in range(depth):
            sums = sums[0::2] + sums[1::2]
            self.sums.append(sums)
        self.hashes: list = []
        sponge = Sponge(device)
        f = sponge.f
        if n > HOST_MAX:
            msgs = [f.to_mont(digest_limbs(digests, device))]
            msgs += [f.to_mont(u64_limbs(balances[:, c], device)) for c in range(ncur)]
            self.hashes.append(sponge.hash(msgs))
        else:
            users = [int.from_bytes(d.tobytes(), "big") % P for d in digests]
            self.hashes.append([PS.hash_n_py([u] + [int(b) for b in row])
                                for u, row in zip(users, balances)])
        for level in range(1, depth + 1):
            below = self.hashes[-1]
            s = self.sums[level]
            if not isinstance(below, list) and s.shape[0] <= HOST_MAX:
                below = [v * R_INV % P for v in ints_from_limbs(below)]
            if isinstance(below, list):
                self.hashes.append([
                    PS.hash_n_py([int(x) % P for x in s[i]] + [below[2 * i], below[2 * i + 1]])
                    for i in range(s.shape[0])])
            else:
                msgs = [f.to_mont(sum_limbs(s[:, c], device)) for c in range(ncur)]
                msgs += [below[:, 0::2], below[:, 1::2]]
                self.hashes.append(sponge.hash(msgs))

    def hash_at(self, level: int, index: int) -> int:
        h = self.hashes[level]
        if isinstance(h, list):
            return h[index]
        return ints_from_limbs(h[:, index:index + 1])[0] * R_INV % P

    def sums_at(self, level: int, index: int) -> list[int]:
        return [int(v) for v in self.sums[level][index]]

    def root(self) -> tuple[int, list[int]]:
        """(root hash, root balances mod r)."""
        return self.hash_at(self.depth, 0), [v % P for v in self.sums_at(self.depth, 0)]

    def path(self, index: int) -> dict:
        """What the inclusion circuit of leaf ``index`` takes from the tree:
        the sibling leaf's preimage, each sibling node's preimage above it,
        the path bits, the root and the leaf's hash."""
        sib = index ^ 1
        leaf_pre = [self._user(sib)] + self.sums_at(0, sib)
        middles, bits = [], []
        for level in range(self.depth):
            cur = index >> level
            bits.append(cur & 1)
            if level >= 1:
                s = cur ^ 1
                middles.append(self.sums_at(level, s)
                               + [self.hash_at(level - 1, 2 * s), self.hash_at(level - 1, 2 * s + 1)])
        root_hash, root_bal = self.root()
        return {"sibling_leaf": leaf_pre, "sibling_middles": middles, "path": bits,
                "root_hash": root_hash, "root_balances": root_bal,
                "leaf_hash": self.hash_at(0, index)}

    def _user(self, index: int) -> int:
        return int.from_bytes(self.digests[index].tobytes(), "big") % P
