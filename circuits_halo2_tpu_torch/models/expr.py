"""Polynomial expression IR for PLONKish gates.

Expressions reference columns through *query indices* (resolved by the
ConstraintSystem), mirroring the halo2 v0.2 expression model the reference
circuits compile to (`zk_prover` gates — see SURVEY.md §2a #8, #11, #13).
Every node can evaluate itself over numpy row-vectors (MockProver, quotient
construction) or single field points (verifier).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.field import FR_MOD


class Expr:
    def __add__(self, other):
        return Sum(self, _wrap(other))

    def __radd__(self, other):
        return Sum(_wrap(other), self)

    def __sub__(self, other):
        return Sum(self, Neg(_wrap(other)))

    def __rsub__(self, other):
        return Sum(_wrap(other), Neg(self))

    def __mul__(self, other):
        other = _wrap(other)
        if isinstance(other, Const):
            return Scaled(self, other.value)
        return Product(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return Neg(self)

    # -- interface ----------------------------------------------------------

    def degree(self) -> int:
        raise NotImplementedError

    def evaluate(self, ops) -> object:
        """Fold with an ops dict: constant, fixed, advice, instance, selector,
        challenge, negated, sum, product, scaled — mirroring halo2's
        ``Expression::evaluate``."""
        raise NotImplementedError


def _wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Const(v % FR_MOD)


@dataclass(frozen=True)
class Const(Expr):
    value: int

    def degree(self):
        return 0

    def evaluate(self, ops):
        return ops["constant"](self.value)


@dataclass(frozen=True)
class Selector(Expr):
    """A virtual selector query — replaced by fixed expressions at compile."""

    index: int
    is_simple: bool = True

    def degree(self):
        return 1

    def evaluate(self, ops):
        return ops["selector"](self.index)


@dataclass(frozen=True)
class FixedQuery(Expr):
    query_index: int
    column: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, ops):
        return ops["fixed"](self.query_index, self.column, self.rotation)


@dataclass(frozen=True)
class AdviceQuery(Expr):
    query_index: int
    column: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, ops):
        return ops["advice"](self.query_index, self.column, self.rotation)


@dataclass(frozen=True)
class InstanceQuery(Expr):
    query_index: int
    column: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, ops):
        return ops["instance"](self.query_index, self.column, self.rotation)


@dataclass(frozen=True)
class Neg(Expr):
    inner: Expr

    def degree(self):
        return self.inner.degree()

    def evaluate(self, ops):
        return ops["negated"](self.inner.evaluate(ops))


@dataclass(frozen=True)
class Sum(Expr):
    left: Expr
    right: Expr

    def degree(self):
        return max(self.left.degree(), self.right.degree())

    def evaluate(self, ops):
        return ops["sum"](self.left.evaluate(ops), self.right.evaluate(ops))


@dataclass(frozen=True)
class Product(Expr):
    left: Expr
    right: Expr

    def degree(self):
        return self.left.degree() + self.right.degree()

    def evaluate(self, ops):
        return ops["product"](self.left.evaluate(ops), self.right.evaluate(ops))


@dataclass(frozen=True)
class Scaled(Expr):
    inner: Expr
    scalar: int

    def degree(self):
        return self.inner.degree()

    def evaluate(self, ops):
        return ops["scaled"](self.inner.evaluate(ops), self.scalar)


def map_selectors(expr: Expr, replacement) -> Expr:
    """Rebuild the expression replacing Selector nodes via replacement(idx)."""
    if isinstance(expr, Selector):
        return replacement(expr.index)
    if isinstance(expr, Neg):
        return Neg(map_selectors(expr.inner, replacement))
    if isinstance(expr, Sum):
        return Sum(
            map_selectors(expr.left, replacement),
            map_selectors(expr.right, replacement),
        )
    if isinstance(expr, Product):
        return Product(
            map_selectors(expr.left, replacement),
            map_selectors(expr.right, replacement),
        )
    if isinstance(expr, Scaled):
        return Scaled(map_selectors(expr.inner, replacement), expr.scalar)
    return expr


def selectors_used(expr: Expr, out: set):
    if isinstance(expr, Selector):
        out.add(expr.index)
    elif isinstance(expr, Neg):
        selectors_used(expr.inner, out)
    elif isinstance(expr, (Sum, Product)):
        selectors_used(expr.left, out)
        selectors_used(expr.right, out)
    elif isinstance(expr, Scaled):
        selectors_used(expr.inner, out)
