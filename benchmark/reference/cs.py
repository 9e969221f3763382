"""Frozen copy of ``circuits_halo2_tpu_torch/models/cs.py`` for the benchmark's
reference (it imports nothing of the port; later changes to the port do
not move it).

PLONKish constraint system builder — the circuit-definition layer.

Provides the halo2-v0.2-equivalent configure-time API (columns, selectors,
gates, lookups, equality/constants) and the compile passes (selector
compression, degree/blinding computation) whose *output layout* is pinned by
the reference's generated verifier (`contracts/src/InclusionVerifier.sol`):
fixed-query order, permutation column order, compressed-selector roots and
the appended fixed columns must all reproduce the reference keygen exactly
for VK/commitment parity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .field import FR_MOD
from . import expr as E


@dataclass(frozen=True)
class Column:
    kind: str  # "advice" | "fixed" | "instance"
    index: int


@dataclass
class Gate:
    name: str
    polys: list


@dataclass
class Lookup:
    name: str
    input_exprs: list
    table_exprs: list


class ConstraintSystem:
    def __init__(self):
        self.num_advice = 0
        self.num_fixed = 0
        self.num_instance = 0
        self.num_selectors = 0
        self.selector_simple: list[bool] = []
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []
        # queries: list of (column_index, rotation)
        self.advice_queries: list[tuple[int, int]] = []
        self.fixed_queries: list[tuple[int, int]] = []
        self.instance_queries: list[tuple[int, int]] = []
        self.num_advice_queries: dict[int, int] = {}
        # permutation argument: columns in enable_equality order
        self.permutation_columns: list[Column] = []
        # constants columns (enable_constant order, duplicates preserved)
        self.constants: list[Column] = []
        # after compression: per-selector (new fixed column index, expression)
        self.selector_map: list = []

    # -- columns ------------------------------------------------------------

    def advice_column(self) -> Column:
        c = Column("advice", self.num_advice)
        self.num_advice += 1
        return c

    def fixed_column(self) -> Column:
        c = Column("fixed", self.num_fixed)
        self.num_fixed += 1
        return c

    def instance_column(self) -> Column:
        c = Column("instance", self.num_instance)
        self.num_instance += 1
        return c

    def selector(self) -> E.Selector:
        s = E.Selector(self.num_selectors, True)
        self.num_selectors += 1
        self.selector_simple.append(True)
        return s

    def complex_selector(self) -> E.Selector:
        s = E.Selector(self.num_selectors, False)
        self.num_selectors += 1
        self.selector_simple.append(False)
        return s

    # -- queries ------------------------------------------------------------

    def query_advice(self, column: Column, rotation: int) -> E.AdviceQuery:
        key = (column.index, rotation)
        if key in self.advice_queries:
            idx = self.advice_queries.index(key)
        else:
            idx = len(self.advice_queries)
            self.advice_queries.append(key)
            self.num_advice_queries[column.index] = (
                self.num_advice_queries.get(column.index, 0) + 1
            )
        return E.AdviceQuery(idx, column.index, rotation)

    def query_fixed(self, column: Column, rotation: int) -> E.FixedQuery:
        key = (column.index, rotation)
        if key in self.fixed_queries:
            idx = self.fixed_queries.index(key)
        else:
            idx = len(self.fixed_queries)
            self.fixed_queries.append(key)
        return E.FixedQuery(idx, column.index, rotation)

    def query_instance(self, column: Column, rotation: int) -> E.InstanceQuery:
        key = (column.index, rotation)
        if key in self.instance_queries:
            idx = self.instance_queries.index(key)
        else:
            idx = len(self.instance_queries)
            self.instance_queries.append(key)
        return E.InstanceQuery(idx, column.index, rotation)

    def query_any(self, column: Column, rotation: int):
        return {
            "advice": self.query_advice,
            "fixed": self.query_fixed,
            "instance": self.query_instance,
        }[column.kind](column, rotation)

    # -- equality / constants ------------------------------------------------

    def enable_equality(self, column: Column):
        if column not in self.permutation_columns:
            self.permutation_columns.append(column)
        self.query_any(column, 0)

    def enable_constant(self, column: Column):
        assert column.kind == "fixed"
        if column not in self.constants:
            self.constants.append(column)
            self.enable_equality(column)

    # -- gates / lookups ------------------------------------------------------

    def create_gate(self, name: str, fn):
        polys = fn(self)
        assert polys, f"gate {name} has no constraints"
        self.gates.append(Gate(name, list(polys)))

    def lookup_any(self, name: str, fn):
        pairs = fn(self)
        inputs = [p[0] for p in pairs]
        tables = [p[1] for p in pairs]
        self.lookups.append(Lookup(name, inputs, tables))

    # -- degrees --------------------------------------------------------------

    def degree(self) -> int:
        d = 3  # permutation argument baseline (l_last · (z² − z))
        for lk in self.lookups:
            inp = max([1] + [e.degree() for e in lk.input_exprs])
            tab = max([1] + [e.degree() for e in lk.table_exprs])
            d = max(d, 2 + inp, 2 + tab, 5)
        for g in self.gates:
            for p in g.polys:
                d = max(d, p.degree())
        # permutation chunking requires degree >= chunk + 2 with chunk >= 1
        return d

    def blinding_factors(self) -> int:
        factors = max(self.num_advice_queries.values(), default=1)
        factors = max(3, factors)
        return factors + 1 + 1

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)

    # -- selector compression -------------------------------------------------

    def compress_selectors(self, activations: list[list[bool]], n: int):
        """Convert selectors into fixed columns exactly as halo2 v0.2 does.

        activations[s] is the per-row enable map for selector s from the
        synthesis run. Appends new fixed columns, rewrites gate/lookup
        expressions, records self.selector_map. Returns the list of new
        fixed-column value vectors (parallel to the appended columns).

        The combining rule (observed output pinned by the reference verifier,
        `InclusionVerifier.sol` gate blocks): a selector's `max_degree`
        EXCLUDES the selector factor itself; selector j joins a combination
        when activations don't overlap and
        ``max(d, d_j) + len(combination) + 1 <= max_degree``.
        """
        max_degree = self.degree()
        # per-selector max gate degree, excluding the selector factor
        degrees = [0] * self.num_selectors
        for g in self.gates:
            for p in g.polys:
                used: set = set()
                E.selectors_used(p, used)
                for s in used:
                    degrees[s] = max(degrees[s], p.degree() - 1)

        new_columns: list[int] = []
        new_values: list[list[int]] = []
        # selector index -> replacement expression
        replacements: dict[int, E.Expr] = {}

        def allocate() -> tuple[int, E.FixedQuery]:
            col = self.fixed_column()
            new_columns.append(col.index)
            return col.index, self.query_fixed(col, 0)

        descs = [
            {"selector": s, "activations": activations[s], "max_degree": degrees[s]}
            for s in range(self.num_selectors)
        ]
        # degree-0 selectors (complex / lookup-only) get dedicated columns first
        rest = []
        for desc in descs:
            if desc["max_degree"] == 0:
                col_idx, q = allocate()
                new_values.append([1 if a else 0 for a in desc["activations"]])
                replacements[desc["selector"]] = q
            else:
                rest.append(desc)

        added = [False] * len(rest)
        for i, desc in enumerate(rest):
            if added[i]:
                continue
            added[i] = True
            d = desc["max_degree"]
            combination = [desc]
            combo_idx = [i]
            for j in range(i + 1, len(rest)):
                if d + len(combination) == max_degree:
                    break
                if added[j]:
                    continue
                overlap = False
                for k in combo_idx:
                    if any(
                        a and b
                        for a, b in zip(
                            rest[j]["activations"], rest[k]["activations"]
                        )
                    ):
                        overlap = True
                        break
                if overlap:
                    continue
                new_d = max(d, rest[j]["max_degree"])
                if new_d + len(combination) + 1 > max_degree:
                    continue
                d = new_d
                combination.append(rest[j])
                combo_idx.append(j)
                added[j] = True

            col_idx, q = allocate()
            values = [0] * n
            roots = list(range(1, len(combination) + 1))
            for root, desc2 in zip(roots, combination):
                expr: E.Expr = q
                for other in roots:
                    if other != root:
                        expr = expr * (E.Const(other) - q)
                replacements[desc2["selector"]] = expr
                for row, active in enumerate(desc2["activations"]):
                    if active:
                        assert values[row] == 0, "overlapping selectors combined"
                        values[row] = root
            new_values.append(values)

        # rewrite gates and lookups
        def repl(idx):
            return replacements[idx]

        for g in self.gates:
            g.polys = [E.map_selectors(p, repl) for p in g.polys]
        for lk in self.lookups:
            lk.input_exprs = [E.map_selectors(p, repl) for p in lk.input_exprs]
            lk.table_exprs = [E.map_selectors(p, repl) for p in lk.table_exprs]
        self.selector_map = [replacements[s] for s in range(self.num_selectors)]

        # pad/crop activation-derived vectors to n rows
        out = []
        for vals in new_values:
            v = list(vals[:n]) + [0] * max(0, n - len(vals))
            out.append(v)
        return new_columns, out
