"""User-side helpers.

Parity target: `backend/src/apis/mod.rs:10-28` — re-derive the leaf hash
from (username, decimal balance strings) so a user can check proof public
input 0 independently.
"""

from __future__ import annotations

from ..merkle.mst import Entry


def leaf_hash_from_inputs(username: str, balances: list[str]) -> int:
    entry = Entry(username, [int(b, 10) for b in balances])
    return entry.compute_leaf().hash
