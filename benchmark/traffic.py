"""The generator every mix reads: a snapshot's leaves, the order users are
proved in, and further balance arrays, all from ``--seed``.

Copied from the port's bench (``bench_suite.seeded_leaves``) and
``chip_smoke.tree_entry``, taking the seed as an argument: the leaves are
uniform 32-byte username digests and balances below 2^``balance_bits``
(one column a currency). The program receives only these arrays, and the
host entry of a leaf made from them.
"""

from __future__ import annotations

import numpy as np

STREAMS = ("leaves", "order", "balances", "blinding", "sample")


def streams(seed: int) -> dict[str, np.random.Generator]:
    """One independent generator a purpose, from any whole-number seed."""
    children = np.random.SeedSequence(seed % (1 << 64)).spawn(len(STREAMS))
    return {name: np.random.default_rng(s) for name, s in zip(STREAMS, children)}


def leaves(rng: np.random.Generator, config: dict) -> tuple[np.ndarray, np.ndarray]:
    """(digests (n, 32) uint8 big-endian, balances (n, C) uint64)."""
    n = 1 << config["levels"]
    digests = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    return digests, balances(rng, config)


def balances(rng: np.random.Generator, config: dict) -> np.ndarray:
    n = 1 << config["levels"]
    return rng.integers(0, 1 << config["balance_bits"], size=(n, config["n_currencies"]),
                        dtype=np.uint64)


def order(rng: np.random.Generator, config: dict) -> np.ndarray:
    """The users in the order they are proved: a permutation of the leaves."""
    return rng.permutation(1 << config["levels"])


def entry(digests: np.ndarray, bals: np.ndarray, index: int):
    """The port's host Entry of leaf ``index``: its username digest is the
    leaf's (no username stands behind it)."""
    from circuits_halo2_tpu_torch.merkle.mst import Entry

    e = Entry.__new__(Entry)
    e.username = f"leaf{index}"
    e.balances = [int(b) for b in bals[index]]
    e.hashed_username = int.from_bytes(digests[index].tobytes(), "big")
    return e
