"""Broken timed paths, for the control and for the tests of the judgement.

Each is a function that changes a set-up loop in place; ``run.execute``
applies one only when a caller asks (``control.py``, ``tests/``), never in
the benchmark's own runs.

- ``understate`` (the control): the guarantee an exchange's users rely on
  broken. A bulk call proves its first user against a balance one lower
  than the snapshot holds; a snapshot build commits one user's balance one
  lower.
- ``stale``: a step returns its state unchanged: every call the proofs of
  the warm-up's users, every build the root of the warm-up's array.
- ``half``: half of the batch left out (half of each call's users proved;
  a snapshot built from the first half of the leaves, the rest zero).
- ``altered``: an answer altered where it is produced (a byte of one proof
  a call; the root hash of a build plus one).
"""

from __future__ import annotations

import numpy as np

from .reference.field import FR_MOD


def understate(loop) -> None:
    if loop.kind == "prove":
        made = loop.circuits

        def circuits(users):
            out = made(users)
            circuit, _ = out[0]
            circuit.entry_balances[0] = (circuit.entry_balances[0] - 1) % FR_MOD
            out[0] = (circuit, circuit.instances())
            return out

        loop.circuits = circuits
    else:
        commit = loop.commit

        def understated(digests, balances):
            lower = balances.copy()
            lower[0, 0] = lower[0, 0] - 1 if lower[0, 0] else 1
            return commit(digests, lower)

        loop.commit = understated


def stale(loop) -> None:
    if loop.kind == "prove":
        users = loop.order[: loop.users_per_call]
        made = loop.circuits(users)
        old = loop.prove([m[0] for m in made], [m[1] for m in made], users)
        loop.prove = lambda circuits, instances, users: old
    else:
        old = loop.commit(loop.digests, loop.arrays[0])
        loop.commit = lambda digests, balances: old


def half(loop) -> None:
    if loop.kind == "prove":
        prove = loop.prove
        loop.prove = lambda circuits, instances, users: prove(
            circuits[: len(circuits) // 2], instances[: len(instances) // 2],
            users[: len(users) // 2])
    else:
        commit = loop.commit

        def half_commit(digests, balances):
            n = len(balances)
            kept = lambda a: np.concatenate([a[: n // 2], np.zeros_like(a[n // 2:])])
            return commit(kept(digests), kept(balances))

        loop.commit = half_commit


def altered(loop) -> None:
    if loop.kind == "prove":
        prove = loop.prove

        def altered_prove(circuits, instances, users):
            out = list(prove(circuits, instances, users))
            proof = bytearray(out[0])
            proof[len(proof) // 2] ^= 1
            out[0] = bytes(proof)
            return out

        loop.prove = altered_prove
    else:
        commit = loop.commit

        def altered_commit(digests, balances):
            h, bals = commit(digests, balances)
            return h + 1, bals

        loop.commit = altered_commit


FAULTS = {"understate": understate, "stale": stale, "half": half, "altered": altered}
