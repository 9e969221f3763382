"""Committing snapshots: ``merkle/device_tree.build_device_tree`` and
``.root()``, again and again.

Set-up: the usernames' digests (fixed, as across rounds) and
``balance_arrays`` balance arrays from the seed, and one build of the first
as warm-up. A step is one build of the next array, from the host arrays to
the root hash and root balances read back on the host, so no two builds in
a row share inputs.

Judged after the window, against ``benchmark/reference`` only: every
build's root hash and root balances against the reference tree of its
array (one reference tree an array).
"""

from __future__ import annotations

import sys
import time

from .. import traffic as T


class Loop:
    kind = "snapshot"

    def __init__(self, cell, seed: int, device, spans):
        self.config = cell.config
        self.traffic = cell.traffic
        self.device = device
        self.spans = spans
        self.rngs = T.streams(seed)
        self.roots: list[tuple[int, tuple]] = []
        self.builds = 0
        self.next = 0

    def setup(self) -> None:
        c = self.config
        self.digests, first = T.leaves(self.rngs["leaves"], c)
        self.arrays = [first] + [T.balances(self.rngs["balances"], c)
                                 for _ in range(int(self.traffic["balance_arrays"]) - 1)]
        self.step(record=False)

    def commit(self, digests, balances):
        """The program: a snapshot's root hash and root balances on the host."""
        from circuits_halo2_tpu_torch.merkle.device_tree import build_device_tree

        with self.spans.span("build_device_tree"):
            tree = build_device_tree(digests, balances, self.device)
        with self.spans.span("root readback"):
            return tree.root()

    def step(self, record: bool = True) -> None:
        j = self.next % len(self.arrays)
        self.next += 1
        root = self.commit(self.digests, self.arrays[j])
        if record:
            self.builds += 1
            self.roots.append((j, root))

    def end_to_end(self, elapsed_s: float) -> dict[str, float]:
        return {"snapshot_s": elapsed_s / self.builds}

    def counts(self) -> dict[str, int]:
        return {"builds": self.builds}

    def free(self) -> None:
        pass

    def judge(self) -> tuple[dict[str, tuple[float, float]], int, int]:
        """({check: (value, limit)}, attempted, failed)."""
        from ..reference.tree import Tree

        t0 = time.perf_counter()
        roots = [Tree(self.digests, a, self.device).root() for a in self.arrays]
        bad_sums = [list(r[1]) != roots[j][1] for j, r in self.roots]
        bad_hash = [r[0] != roots[j][0] for j, r in self.roots]
        print(f"reference: {len(roots)} trees {time.perf_counter() - t0:.2f} s", file=sys.stderr)
        checks = {"root_balance_mismatch": (sum(bad_sums), 0),
                  "root_hash_mismatch": (sum(bad_hash), 0)}
        return checks, len(self.roots), sum(a or b for a, b in zip(bad_sums, bad_hash))

