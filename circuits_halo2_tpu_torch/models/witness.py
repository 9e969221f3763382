"""Phase 1's advice columns: the layouter's, or for ``MstInclusionCircuit``
a plan fixed by the key and one native fill.

The circuit's layout does not depend on its witness: every region has the
same rows whatever the values (a swap region is always 2 rows, a range
check always N_BYTES + 1), so the row of every advice cell is fixed by the
key's (levels, n_currencies, n_bytes, k). The plan records it once per key:
the layouter runs on a witness-free circuit, and the plan keeps, in the
order the synthesis assigns them, the column * n + row of its advice cells.
A prove then fills the advice of all its users in one native call
(``native.mst_witness_fill``): the values the synthesis would assign, in
the same order, computed in Montgomery form and scattered through the plan
straight into the prover's (16, U, ncols, n) limb layout, with each user's
blinding rows. Rows the plan does not name are 0, as in the ``Assignment``.

Only a circuit whose synthesis is ``MstInclusionCircuit``'s own takes the
plan (``plan_for``); a subclass that assigns its own cells (the incremental
and chained circuits) keeps the layouter, as does a batch that mixes them.
``advice_limbs`` takes the route and counts its users (``utils/tracing``:
``witness``/``plan``, ``witness``/``layouter``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from ..ops import field_torch as FT
from ..ops.field import FR_MOD
from ..utils import tracing as TR
from .assignment import Assignment
from .mst_inclusion import MstInclusionCircuit

@dataclass(frozen=True)
class WitnessPlan:
    shape: tuple[int, int, int]  # (levels, n_currencies, n_bytes)
    ncols: int                   # advice columns
    n: int                       # rows, 2^k
    index: np.ndarray            # int64 column * n + row of each advice cell, in order


class _CellLog(Assignment):
    """An ``Assignment`` that also keeps every advice cell, in the order
    assigned, with its absolute row."""

    def __init__(self, *args):
        super().__init__(*args)
        self.cells = []

    def assign_region(self, name, fn):
        regions = []

        def body(region):
            regions.append(region)
            return fn(region)

        out = super().assign_region(name, body)
        self.cells.extend(regions[0].cells)
        return out


def build_plan(cs, config, shape: tuple[int, int, int], n: int) -> WitnessPlan:
    """Run the layouter once on a witness-free circuit of ``shape``."""
    circuit = MstInclusionCircuit.init_empty(*shape)
    asn = _CellLog(cs, n, [[0] * circuit.num_instances()])
    circuit.synthesize(config, asn)
    index = np.array([c.column.index * n + c.row for c in asn.cells], dtype=np.int64)
    return WitnessPlan(shape, cs.num_advice, n, index)


def takes_plan(circuit) -> bool:
    """Whether ``circuit`` synthesises through ``MstInclusionCircuit``'s own
    ``synthesize``, the one the native fill reproduces."""
    return (isinstance(circuit, MstInclusionCircuit)
            and type(circuit).synthesize is MstInclusionCircuit.synthesize)


def plan_for(pk, config, circuits) -> WitnessPlan | None:
    """The key's plan for a batch, built on first use and kept on ``pk``;
    None where some circuit synthesises its own cells or the batch mixes
    shapes (the batch then takes the layouter)."""
    if not all(takes_plan(c) for c in circuits):
        return None
    shapes = {(c.levels, c.n_currencies, c.n_bytes) for c in circuits}
    if len(shapes) != 1:
        return None
    (shape,) = shapes
    cache = pk.__dict__.setdefault("_witness_plan_cache", {})
    cached = cache.get(shape)
    if cached is None or cached[0] is not config:
        cached = (config, build_plan(pk.vk.cs, config, shape, 1 << pk.vk.k))
        cache[shape] = cached
    return cached[1]


def _inputs(c: MstInclusionCircuit) -> list[int]:
    """One user's inputs in the native fill's order."""
    ncur = c.n_currencies
    if len(c.entry_balances) != ncur or len(c.path_indices) != c.levels:
        raise ValueError("the witness does not match the circuit's shape")
    out = [c.entry_username, *c.entry_balances, *c.path_indices]
    out += [c.sibling_leaf_node_hash_preimage[i] for i in range(ncur + 1)]
    for level in range(1, c.levels):
        pre = c.sibling_middle_node_hash_preimages[level - 1]
        out += [pre[i] for i in range(ncur + 2)]
    return out


def fill(plan: WitnessPlan, circuits, blinds, usable: int) -> np.ndarray:
    """(16, U, ncols, n) int64 Montgomery limbs of the U circuits' advice:
    byte for byte what ``circuit.synthesize`` assigns, with ``blinds[u][col]``
    (n - usable scalars a column) in rows usable..n."""
    inputs = native.scalars_to_bytes([v % FR_MOD for c in circuits for v in _inputs(c)])
    draws = native.scalars_to_bytes([v for user in blinds for col in user for v in col])
    out = np.zeros((FT.NLIMBS, len(circuits), plan.ncols, plan.n), dtype=np.int64)
    native.mst_witness_fill(inputs, draws, plan.shape, plan.index, usable, out)
    return out


def blinding_draws(rng, ncols: int, usable: int, n: int) -> list[list[int]]:
    """One user's advice blinders: rows usable..n, column by column."""
    return [[rng.next_field() for _ in range(usable, n)] for _ in range(ncols)]


def advice_limbs(pk, config, circuits, instances_list, rngs, usable: int) -> np.ndarray:
    """The batch's blinded advice, (16, U, ncols, n) Montgomery limbs:
    through the key's plan where every circuit takes it, else each
    circuit's ``synthesize`` through the layouter."""
    cs, n, nusers = pk.vk.cs, 1 << pk.vk.k, len(circuits)
    plan = plan_for(pk, config, circuits)
    if plan is not None:
        if TR.on:
            TR.count("witness", "plan", users=nusers)
        blinds = []
        for u, rng in enumerate(rngs):
            with TR.span("blinding_draws", u):
                blinds.append(blinding_draws(rng, plan.ncols, usable, n))
        with TR.span("synthesize"):
            return fill(plan, circuits, blinds, usable)
    if TR.on:
        TR.count("witness", "layouter", users=nusers)
    cols = []
    for u, (circuit, instances, rng) in enumerate(zip(circuits, instances_list, rngs)):
        with TR.span("synthesize", u):
            asn = Assignment(cs, n, instances)
            circuit.synthesize(config, asn)
        with TR.span("blinding_draws", u):
            for col, draws in zip(asn.advice, blinding_draws(rng, cs.num_advice, usable, n)):
                col[usable:] = draws
        cols += asn.advice
    with TR.span("to_limbs"):
        flat = FT.to_mont_limbs([v for col in cols for v in col])
    return flat.reshape(FT.NLIMBS, nusers, cs.num_advice, n)
