"""Region-based circuit assignment with SimpleFloorPlanner placement.

Reproduces halo2's single-chip layouter semantics exactly (placement is part
of the proof system's committed layout, so parity requires it):

- a region's start row = max over the distinct columns (selectors count as
  columns) it touches of that column's high-water mark;
- after placement every touched column's mark becomes start + region height;
- copies are recorded in call order during the region body, then constants
  requested via ``assign_advice_from_constant``/``constrain_constant`` are
  appended at region exit to the FIRST constants column, using that column's
  shared high-water mark.

The ordered copy list feeds the permutation-argument keygen Assembly; its
order shapes the sigma polynomials, hence the VK commitments.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.field import FR_MOD
from .cs import Column, ConstraintSystem


@dataclass
class Cell:
    column: Column
    offset: int             # offset inside its region
    row: int | None = None  # absolute row, set when the region commits
    value: int = 0


class Region:
    """Buffered region; ops are committed with an absolute start row."""

    def __init__(self, name: str, assignment: "Assignment"):
        self.name = name
        self.assignment = assignment
        self.used_columns: set = set()
        self.height = 0
        self.ops: list = []
        self.copies: list[tuple[Cell, Cell]] = []
        self.constants: list[tuple[int, Cell]] = []
        self.cells: list[Cell] = []

    def _touch(self, column_key, offset: int):
        self.used_columns.add(column_key)
        self.height = max(self.height, offset + 1)

    def enable_selector(self, selector, offset: int):
        self._touch(("selector", selector.index), offset)
        self.ops.append(("selector", selector.index, offset))

    def assign_advice(self, column: Column, offset: int, value: int) -> Cell:
        self._touch(column, offset)
        cell = Cell(column, offset, value=value % FR_MOD)
        self.cells.append(cell)
        self.ops.append(("advice", column, offset, cell.value))
        return cell

    def assign_fixed(self, column: Column, offset: int, value: int):
        self._touch(column, offset)
        self.ops.append(("fixed", column, offset, value % FR_MOD))

    def copy_advice(self, src: Cell, column: Column, offset: int) -> Cell:
        cell = self.assign_advice(column, offset, src.value)
        self.copies.append((src, cell))
        return cell

    def assign_advice_from_constant(
        self, column: Column, offset: int, value: int
    ) -> Cell:
        cell = self.assign_advice(column, offset, value)
        self.constants.append((value % FR_MOD, cell))
        return cell

    def constrain_constant(self, cell: Cell, value: int):
        self.constants.append((value % FR_MOD, cell))

    def constrain_equal(self, a: Cell, b: Cell):
        self.copies.append((a, b))


class Assignment:
    """The full circuit assignment: fixed/advice/instance values + copies."""

    def __init__(self, cs: ConstraintSystem, n: int, instance: list[list[int]]):
        self.cs = cs
        self.n = n
        self.fixed = [[0] * n for _ in range(cs.num_fixed)]
        self.advice = [[0] * n for _ in range(cs.num_advice)]
        self.selectors = [[False] * n for _ in range(cs.num_selectors)]
        self.instance = [
            [v % FR_MOD for v in col] + [0] * (n - len(col)) for col in instance
        ]
        self.columns: dict = {}  # column/selector key -> next free row
        # copies in final ((column, row), (column, row)) form, in order
        self.copies: list[tuple[tuple[Column, int], tuple[Column, int]]] = []
        self.usable_rows = cs.usable_rows(n)
        # layout log for the dev-graph-equivalent renderer (models/layout):
        # (region name, start row, height, used column keys)
        self.regions_log: list[tuple[str, int, int, list]] = []

    def assign_region(self, name: str, fn):
        region = Region(name, self)
        result = fn(region)

        start = 0
        for col in region.used_columns:
            start = max(start, self.columns.get(col, 0))
        for col in region.used_columns:
            self.columns[col] = start + region.height
        self.regions_log.append(
            (name, start, region.height, sorted(region.used_columns, key=repr))
        )

        for op in region.ops:
            kind = op[0]
            if kind == "selector":
                _, idx, offset = op
                row = start + offset
                assert row < self.usable_rows, f"{name}: selector beyond usable rows"
                self.selectors[idx][row] = True
            elif kind == "advice":
                _, column, offset, value = op
                row = start + offset
                assert row < self.usable_rows, f"{name}: advice beyond usable rows"
                self.advice[column.index][row] = value
            else:  # fixed
                _, column, offset, value = op
                row = start + offset
                assert row < self.usable_rows, f"{name}: fixed beyond usable rows"
                self.fixed[column.index][row] = value
        for cell in region.cells:
            cell.row = start + cell.offset

        # copies recorded during the body, in call order
        for a, b in region.copies:
            assert a.row is not None and b.row is not None, f"{name}: dangling copy"
            self.copies.append(((a.column, a.row), (b.column, b.row)))

        # constants appended at region exit into the first constants column
        if region.constants:
            constants_column = self.cs.constants[0]
            next_row = self.columns.get(constants_column, 0)
            for value, cell in region.constants:
                assert next_row < self.usable_rows, "constants beyond usable rows"
                self.fixed[constants_column.index][next_row] = value
                self.copies.append(
                    ((constants_column, next_row), (cell.column, cell.row))
                )
                next_row += 1
            self.columns[constants_column] = next_row
        return result

    def constrain_instance(self, cell: Cell, instance_column: Column, row: int):
        assert cell.row is not None
        self.copies.append(
            ((cell.column, cell.row), (instance_column, row))
        )
