"""Device-resident Merkle sum tree build -- the large-scale witness path of
``circuits_halo2_tpu/merkle/device_tree.py``.

- usernames (keccak digests) and u64 balances become 16-bit limb tensors by
  vectorised numpy byte views (no per-element Python);
- balance sums stay RAW exact integers across levels (< 2^84 for 2^20
  entries x u64), added limb-wise with one carry pass; they are converted
  to Montgomery form only where they enter a hash preimage. Montgomery-
  resident sums would be full-width field elements, and the reference's
  redundant-limb hash kernel went out of its envelope on them from level 6
  up; exact raw sums keep every value small and every level exact;
- every level is one K1 launch (``ops/poseidon_kernel.hash_batch``);
- only the root and queried nodes come back to the host.

``tree_root_mxu`` computes the same root through K4
(``ops/poseidon_mxu.hash_batch_mxu``), the tensor-core sponge of plain
residues: raw digests and raw sums go in with no Montgomery conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field as F
from ..ops import field_torch as FT
from ..ops import poseidon_kernel as PK
from ..ops import poseidon_mxu as PM
from ..utils import tracing as TR

P = F.FR_MOD


def u64_to_limbs16(values: np.ndarray) -> np.ndarray:
    """(N,) uint64 -> (16, N) int64 limbs (the top 12 are zero)."""
    le = np.ascontiguousarray(values.astype("<u8"))
    out = np.zeros((FT.NLIMBS, len(le)), dtype=np.int64)
    out[:4] = le.view("<u2").reshape(len(le), 4).T
    return out


def digests_to_limbs16(digests: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 big-endian keccak digests -> (16, N) int64 limbs of the
    full 256-bit value (reduced mod p by the Montgomery conversion)."""
    le = np.ascontiguousarray(digests[:, ::-1])
    return np.ascontiguousarray(le.view("<u2").reshape(len(le), FT.NLIMBS).T).astype(np.int64)


def _to_mont_cols(raw: torch.Tensor) -> torch.Tensor:
    """(C, 16, w) raw limbs -> (C, 16, w) Montgomery (limb axis moved first)."""
    return FT.to_mont(raw.movedim(1, 0)).movedim(0, 1)


def _add_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact limb-wise sum of (C, 16, w) raw integers."""
    limbs, _ = FT.normalize((a + b).movedim(1, 0).contiguous())
    return limbs.movedim(0, 1).contiguous()


class DeviceMst:
    """Every level as device tensors: hashes (16, n_l) Montgomery, balance
    sums (C, 16, n_l) raw exact limbs, leaf usernames (16, n) Montgomery."""

    def __init__(self, level_hashes, level_balances, depth, n_currencies, user_limbs):
        self.level_hashes = level_hashes
        self.level_balances = level_balances
        self.depth = depth
        self.n_currencies = n_currencies
        self.user_limbs = user_limbs

    @staticmethod
    def _val(col) -> int:
        return FT.from_mont_ints(col)[0]

    @staticmethod
    def _val_raw(col) -> int:
        return FT.limbs_to_ints(col)[0]

    def root(self):
        """(root_hash, [root_balances]) as canonical integers."""
        h = self._val(self.level_hashes[-1][:, :1])
        bals = [self._val_raw(self.level_balances[-1][c, :, :1]) % P
                for c in range(self.n_currencies)]
        return h, bals

    def generate_proof(self, index: int, entry):
        """MerkleProof for leaf ``index``; ``entry`` is its host Entry (the
        device keeps only username digests). O(depth) host conversions."""
        from .mst import MerkleProof, Node

        c = self.n_currencies
        sib = index ^ 1
        sibling_leaf_preimage = [self._val(self.user_limbs[:, sib : sib + 1])] + [
            self._val_raw(self.level_balances[0][i, :, sib : sib + 1]) for i in range(c)]
        middles = []
        path = []
        for level in range(self.depth):
            cur = index >> level
            path.append(cur & 1)
            if level >= 1:
                s = cur ^ 1
                bal = [self._val_raw(self.level_balances[level][i, :, s : s + 1])
                       for i in range(c)]
                below = self.level_hashes[level - 1]
                middles.append(bal + [self._val(below[:, 2 * s : 2 * s + 1]),
                                      self._val(below[:, 2 * s + 1 : 2 * s + 2])])
        root_h, root_b = self.root()
        return MerkleProof(entry, Node(root_h, root_b), sibling_leaf_preimage, middles, path)


def build_device_tree(hashed_usernames: np.ndarray, balances: np.ndarray, device) -> DeviceMst:
    """hashed_usernames: (N, 32) uint8 keccak digests (or zeros); balances:
    (N, C) uint64. N must be a power of two."""
    n, ncur = balances.shape
    depth = (n - 1).bit_length()
    if n != 1 << depth:
        raise ValueError("entry count must be a power of two")
    with TR.span("tree_convert"):
        user_np = digests_to_limbs16(hashed_usernames)
        bal_np = [u64_to_limbs16(balances[:, c]) for c in range(ncur)]
    with TR.span("h2d"):
        user_raw = torch.as_tensor(user_np, device=device)
        bal_raw = torch.stack([torch.as_tensor(b, device=device) for b in bal_np])
    if TR.on and user_raw.device.type != "cpu":
        TR.count("copy", "device_tree", h2d_bytes=user_np.nbytes + sum(b.nbytes for b in bal_np))
    del user_np, bal_np
    user = FT.to_mont(user_raw)
    leaf_hashes = PK.hash_batch(torch.cat([user[None], _to_mont_cols(bal_raw)]))

    level_hashes = [leaf_hashes]
    level_balances = [bal_raw]
    for _ in range(depth):
        h = level_hashes[-1]
        b = level_balances[-1]
        sums = _add_raw(b[:, :, 0::2], b[:, :, 1::2])
        pre = torch.cat([_to_mont_cols(sums), h[None, :, 0::2], h[None, :, 1::2]])
        level_hashes.append(PK.hash_batch(pre))
        level_balances.append(sums)
    return DeviceMst(level_hashes, level_balances, depth, ncur, user)


def build_device_tree_sorted(usernames: np.ndarray, hashed_usernames: np.ndarray,
                             balances: np.ndarray, device="cuda:0"):
    """``build_device_tree`` of the entries ordered by username (a stable
    host ``np.argsort``), so lookups can bisect. Returns (DeviceMst, order):
    ``order[i]`` is the original index of the entry at sorted position i."""
    order = np.argsort(np.asarray(usernames), kind="stable")
    return build_device_tree(hashed_usernames[order], balances[order], device), order


def tree_root_mxu(hashed_usernames: np.ndarray, balances: np.ndarray, device="cuda:0"):
    """(root_hash, [root_balances]) of the tree ``build_device_tree`` builds,
    level by level through K4: leaves hash (raw digest, balances), every
    level above hashes (raw sums, left hash, right hash)."""
    n, ncur = balances.shape
    depth = (n - 1).bit_length()
    if n != 1 << depth:
        raise ValueError("entry count must be a power of two")
    user = torch.as_tensor(digests_to_limbs16(hashed_usernames), device=device)
    sums = torch.stack([torch.as_tensor(u64_to_limbs16(balances[:, c]), device=device)
                        for c in range(ncur)])
    hashes = PM.hash_batch_mxu(torch.cat([user[None], sums]))
    for _ in range(depth):
        sums = _add_raw(sums[:, :, 0::2], sums[:, :, 1::2])
        hashes = PM.hash_batch_mxu(torch.cat([sums, hashes[None, :, 0::2], hashes[None, :, 1::2]]))
    return (FT.limbs_to_ints(hashes[:, :1])[0],
            [FT.limbs_to_ints(sums[c, :, :1])[0] % P for c in range(ncur)])
