"""MockProver — direct constraint evaluation on the witness with precise
failure reporting.

The halo2 ``MockProver`` equivalent (reference test strategy, SURVEY §4:
exact per-gate/per-row failure assertions in `zk_prover/src/circuits/
tests.rs`). Evaluates every gate polynomial at every row, checks lookups by
multiset membership, and checks copy constraints by value equality.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.field import FR_MOD
from .assignment import Assignment
from .cs import ConstraintSystem

P = FR_MOD


@dataclass(frozen=True)
class GateFailure:
    gate: str
    poly_index: int
    row: int
    # Enclosing region (halo2 FailureLocation::InRegion equivalent —
    # reference negative tests assert these, e.g. region "permute state"
    # offset 36, `zk_prover/src/circuits/tests.rs:91-123`).
    region: str | None = None
    offset: int | None = None


@dataclass(frozen=True)
class LookupFailure:
    lookup: str
    row: int


@dataclass(frozen=True)
class CopyFailure:
    left: tuple
    right: tuple


class MockProver:
    """Runs a circuit's synthesis and checks every constraint on the result."""

    def __init__(self, k: int, circuit, instances: list[list[int]]):
        self.n = 1 << k
        self.cs = ConstraintSystem()
        self.config = circuit.configure(self.cs)
        self.asn = Assignment(self.cs, self.n, instances)
        circuit.synthesize(self.config, self.asn)

    def verify(self) -> list:
        cs, asn, n = self.cs, self.asn, self.n
        failures: list = []
        advice = asn.advice
        fixed = asn.fixed
        instance = asn.instance
        selectors = asn.selectors
        usable = asn.usable_rows

        def ops_for_row(row: int):
            return {
                "constant": lambda v: v % P,
                "selector": lambda idx: 1 if selectors[idx][row] else 0,
                "fixed": lambda q, c, r: fixed[c][(row + r) % n],
                "advice": lambda q, c, r: advice[c][(row + r) % n],
                "instance": lambda q, c, r: instance[c][(row + r) % n],
                "negated": lambda a: (-a) % P,
                "sum": lambda a, b: (a + b) % P,
                "product": lambda a, b: a * b % P,
                "scaled": lambda a, k: a * k % P,
            }

        def region_of(row: int) -> tuple[str | None, int | None]:
            """Innermost (latest-started) region covering a row, and the
            row's offset inside it — halo2's FailureLocation::InRegion."""
            best = None
            for name, start, height, _ in asn.regions_log:
                if start <= row < start + height:
                    if best is None or start >= best[1]:
                        best = (name, start)
            if best is None:
                return None, None
            return best[0], row - best[1]

        # evaluate each gate only where one of its selectors is enabled —
        # everywhere else the (uncompressed) selector factor is zero.
        from . import expr as E

        for gate in cs.gates:
            sels: set = set()
            for poly in gate.polys:
                E.selectors_used(poly, sels)
            if sels:
                rows = sorted(
                    {
                        row
                        for s in sels
                        for row in range(usable)
                        if selectors[s][row]
                    }
                )
            else:
                rows = range(usable)
            for row in rows:
                ops = ops_for_row(row)
                for pi, poly in enumerate(gate.polys):
                    if poly.evaluate(ops) != 0:
                        reg, off = region_of(row)
                        failures.append(
                            GateFailure(gate.name, pi, row, reg, off)
                        )

        for lk in cs.lookups:
            table = set()
            for row in range(usable):
                ops = ops_for_row(row)
                acc = 0
                for expr in lk.table_exprs:
                    acc = (acc << 256) | expr.evaluate(ops)
                table.add(acc)
            for row in range(usable):
                ops = ops_for_row(row)
                acc = 0
                for expr in lk.input_exprs:
                    acc = (acc << 256) | expr.evaluate(ops)
                if acc not in table:
                    failures.append(LookupFailure(lk.name, row))

        def cell_value(column, row):
            if column.kind == "advice":
                return advice[column.index][row]
            if column.kind == "fixed":
                return fixed[column.index][row]
            return instance[column.index][row]

        for left, right in asn.copies:
            lv = cell_value(left[0], left[1])
            rv = cell_value(right[0], right[1])
            if lv != rv:
                failures.append(
                    CopyFailure(
                        (left[0].kind, left[0].index, left[1], lv),
                        (right[0].kind, right[0].index, right[1], rv),
                    )
                )
        return failures

    def assert_satisfied(self):
        failures = self.verify()
        if failures:
            preview = "\n".join(str(f) for f in failures[:20])
            raise AssertionError(
                f"{len(failures)} constraint failures:\n{preview}"
            )
