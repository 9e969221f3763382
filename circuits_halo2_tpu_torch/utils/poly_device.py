"""Device polynomial backend for the prover (``circuits_halo2_tpu/utils/poly_device.py``).

Polynomials are ``(16, *batch, n)`` int64 Montgomery limb tensors on one
device. Lagrange <-> coefficient transforms, coset-extended evaluation,
log-depth prefix/suffix scans, batched inversion, point evaluation and
linear division all run as torch ops there; the host touches only scalars.
"""

from __future__ import annotations

import functools

import torch

from .. import native
from ..ops import field as F
from ..ops import field_torch as FT
from ..ops import ntt as NTT

P = F.FR_MOD
R_INV = pow(1 << 256, -1, P)

# Coset generator for the extended domain (any non-subgroup element works).
COSET_GEN = 7


def intt_cols(cols: list[list[int]], omega: int, device) -> list[list[int]]:
    """Batched inverse NTT of host-int columns (keygen's Lagrange -> coeff)."""
    if not cols:
        return []
    n = len(cols[0])
    flat = FT.to_mont_limbs([v for col in cols for v in col]).reshape(FT.NLIMBS, len(cols), n)
    out = NTT.intt(torch.as_tensor(flat, device=device), omega)
    vals = FT.from_mont_ints(out.reshape(FT.NLIMBS, -1))
    return [vals[i * n : (i + 1) * n] for i in range(len(cols))]


def _one_like(a: torch.Tensor) -> torch.Tensor:
    return FT.const_tensor(FT.FR.one_mont, a.device, a.dim()).expand_as(a)


def _shift_scan(a: torch.Tensor, op, identity: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Hillis-Steele inclusive scan along the last axis with a field op;
    ``identity`` broadcasts against a (16, *batch, 1) slice."""
    n = a.shape[-1]
    d = 1
    while d < n:
        pad = identity.expand(a.shape[:-1] + (d,))
        if reverse:
            prev = torch.cat([a[..., d:], pad], dim=-1)
        else:
            prev = torch.cat([pad, a[..., :-d]], dim=-1)
        a = op(a, prev)
        d *= 2
    return a


def mont_cumprod(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the last axis (Montgomery form)."""
    return _shift_scan(a, FT.mont_mul, _one_like(a[..., :1]), reverse=False)


def batch_inv_dev(a: torch.Tensor) -> torch.Tensor:
    """Batched inversion along the last axis with one Fermat inversion per
    row. All inputs must be nonzero (halo2's batch_invert contract)."""
    one = _one_like(a[..., :1])
    pre = _shift_scan(a, FT.mont_mul, one, reverse=False)
    suf = _shift_scan(a, FT.mont_mul, one, reverse=True)
    tinv = FT.inv_mont(pre[..., -1:].contiguous())
    left = torch.cat([one, pre[..., :-1]], dim=-1)
    right = torch.cat([suf[..., 1:], one], dim=-1)
    return FT.mont_mul(FT.mont_mul(left, right), tinv)


def _powers_dev(x: torch.Tensor, n: int) -> torch.Tensor:
    """(16, *batch, 1) Montgomery x -> (16, *batch, n) powers [1, x, x^2, ...]."""
    a = x.expand(x.shape[:-1] + (n,)).clone()
    one = _one_like(a[..., :1])
    a[..., :1] = one
    return _shift_scan(a, FT.mont_mul, one, reverse=False)


def powers_dev(x: int, n: int, device) -> torch.Tensor:
    """Powers vector of a host scalar on device (Montgomery limbs)."""
    return _powers_dev(FT.const_tensor(FT.FR.const(x), device, 2), n)


def tree_sum_mod(a: torch.Tensor) -> torch.Tensor:
    """Log-depth sum along the (power-of-two) last axis -> size-1 axis."""
    while a.shape[-1] > 1:
        half = a.shape[-1] // 2
        a = FT.add_mod(a[..., :half], a[..., half:])
    return a


def eval_coeffs_at(coeffs: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """Evaluate coefficient-form polys (16, *batch, n) at the point whose
    powers vector is ``pw`` (16, n) -> (16, *batch, 1)."""
    t = FT.mont_mul(coeffs, pw.reshape((FT.NLIMBS,) + (1,) * (coeffs.dim() - 2) + (-1,)))
    return tree_sum_mod(t)


def _divide_linear_dev(coeffs: torch.Tensor, pw: torch.Tensor, ipw: torch.Tensor) -> torch.Tensor:
    """q = coeffs / (X - z), exact division, via the suffix-sum identity
    q_i = z^-(i+1) · sum_{j>i} c_j z^j. pw/ipw: (16, n) powers of z and
    z^-1 (or (16, *batch, n), one point per batch entry). Output has n
    lanes; lane n-1 is zero."""
    t = FT.mont_mul(coeffs, pw)
    zero = torch.zeros_like(t[..., :1])
    suf = _shift_scan(t, FT.add_mod, zero, reverse=True)
    s = torch.cat([suf[..., 1:], zero], dim=-1)  # exclusive: sum_{j>i}
    return FT.mont_mul(FT.mont_mul(s, ipw), ipw[..., 1:2])


def divide_linear_dev(coeffs: torch.Tensor, z: int) -> torch.Tensor:
    """Exact division of a (16, n) coefficient tensor by (X - z)."""
    n = int(coeffs.shape[-1])
    pw = powers_dev(z, n, coeffs.device)
    ipw = powers_dev(pow(z % P, -1, P), n, coeffs.device)
    return _divide_linear_dev(coeffs, pw, ipw)


class Domain:
    """Evaluation domain of size n = 2^k on one device, extended size
    2^(k + ext_bits) on the coset COSET_GEN."""

    def __init__(self, k: int, degree: int, device):
        self.k = k
        self.n = 1 << k
        self.device = torch.device(device)
        ext_bits = max(1, (degree - 1).bit_length())
        self.k_ext = k + ext_bits
        self.n_ext = 1 << self.k_ext
        self.omega = NTT.omega_for_k(k)
        self.omega_ext = NTT.omega_for_k(self.k_ext)
        self.rot_scale = self.n_ext // self.n

        g_pows = [1] * self.n_ext
        for i in range(1, self.n_ext):
            g_pows[i] = g_pows[i - 1] * COSET_GEN % P
        g_inv = F.fr_inv(COSET_GEN)
        gi_pows = [1] * self.n_ext
        for i in range(1, self.n_ext):
            gi_pows[i] = gi_pows[i - 1] * g_inv % P
        self._coset = self.to_device(g_pows)
        self._coset_inv = self.to_device(gi_pows)
        # 1 / Zh(coset point) = 1 / (g^n · w_ext^(n·i) - 1)
        gn = F.fr_pow(COSET_GEN, self.n)
        w_n = F.fr_pow(self.omega_ext, self.n)
        zh = [(gn * F.fr_pow(w_n, i) - 1) % P for i in range(self.n_ext)]
        self._zh_inv = self.to_device(native.batch_inv(zh))
        # the transforms' factors (X1 applies them as it loads or stores):
        # g^j on coeff_to_extended's input, 1 / Zh on vanishing_to_coeff's,
        # n_ext^-1 g^-k on the coefficients out of the inverse
        n_ext_inv = F.fr_inv(self.n_ext)
        self._omega_ext_inv = F.fr_inv(self.omega_ext)
        self._coset_lanes = NTT.Lanes(self._coset)
        self._zh_inv_lanes = NTT.Lanes(self._zh_inv)
        self._to_coeff_lanes = NTT.Lanes(self.to_device([v * n_ext_inv % P for v in gi_pows]))
        self._omega_pows = None
        self._x_ext = None
        self._consts: dict[tuple, torch.Tensor] = {}

    # -- conversions --------------------------------------------------------

    def to_device(self, values: list[int]) -> torch.Tensor:
        """Host ints -> (16, len) Montgomery limbs."""
        return torch.as_tensor(FT.to_mont_limbs(values), device=self.device)

    def cols_to_device(self, cols: list[list[int]]) -> torch.Tensor:
        """B same-length host columns -> (16, B, n) Montgomery."""
        flat = FT.to_mont_limbs([v for col in cols for v in col])
        return torch.as_tensor(flat.reshape(FT.NLIMBS, len(cols), len(cols[0])),
                               device=self.device)

    def from_device(self, limbs: torch.Tensor) -> list[int]:
        """(16, N) Montgomery limbs -> N canonical ints."""
        return FT.from_mont_ints(limbs)

    # -- tables -------------------------------------------------------------

    @property
    def omega_pows(self) -> torch.Tensor:
        """(16, n) powers of omega (Montgomery)."""
        if self._omega_pows is None:
            self._omega_pows = powers_dev(self.omega, self.n, self.device)
        return self._omega_pows

    @property
    def x_ext(self) -> torch.Tensor:
        """The identity polynomial X on the coset extended grid: lane i is
        g·omega_ext^i."""
        if self._x_ext is None:
            pw = powers_dev(self.omega_ext, self.n_ext, self.device)
            self._x_ext = FT.mont_mul(pw, self.const_dev(COSET_GEN))
        return self._x_ext

    def const_dev(self, value: int, ndim: int = 2) -> torch.Tensor:
        """(16, 1, ..., 1) Montgomery constant of ``ndim`` axes on the
        domain's device (cached)."""
        key = (value % P, ndim)
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(FT.FR.const(key[0]), device=self.device)
            t = self._consts[key] = t.reshape((FT.NLIMBS,) + (1,) * (ndim - 1))
        return t

    # -- transforms ---------------------------------------------------------

    def _lanes(self, table: torch.Tensor, ndim: int) -> torch.Tensor:
        return table.reshape((FT.NLIMBS,) + (1,) * (ndim - 2) + (-1,))

    def lagrange_to_coeff(self, dev_values: torch.Tensor) -> torch.Tensor:
        return NTT.intt(dev_values, self.omega)

    def coeff_to_extended(self, dev_coeffs: torch.Tensor) -> torch.Tensor:
        """(16, *batch, m) coefficients, m <= n_ext (the rest zero) ->
        (16, *batch, n_ext) coset evaluations; the coset factors g^j are
        applied as the transform loads the m coefficients."""
        return NTT.transform(dev_coeffs, self.omega_ext, self.n_ext, in_scale=self._coset_lanes)

    def extended_to_coeff(self, dev_evals: torch.Tensor) -> torch.Tensor:
        """Coset evaluations -> coefficients: the inverse transform with
        n_ext^-1 g^-k applied as it stores."""
        return NTT.transform(dev_evals, self._omega_ext_inv, out_scale=self._to_coeff_lanes)

    def divide_by_vanishing(self, dev_evals: torch.Tensor) -> torch.Tensor:
        return FT.mont_mul(dev_evals, self._lanes(self._zh_inv, dev_evals.dim()))

    def vanishing_to_coeff(self, dev_evals: torch.Tensor) -> torch.Tensor:
        """``extended_to_coeff(divide_by_vanishing(dev_evals))`` in one
        transform: 1 / Zh applied as it loads."""
        return NTT.transform(dev_evals, self._omega_ext_inv, in_scale=self._zh_inv_lanes,
                             out_scale=self._to_coeff_lanes)

    def rotate_ext(self, dev_evals: torch.Tensor, rotation: int) -> torch.Tensor:
        """Rotation by omega^rot on the extended evaluation grid."""
        return torch.roll(dev_evals, -rotation * self.rot_scale, dims=-1)

    def rotate_base(self, dev_values: torch.Tensor, rotation: int) -> torch.Tensor:
        """Rotation by omega^rot on the base grid (row i -> i + rot)."""
        return torch.roll(dev_values, -rotation, dims=-1)


@functools.lru_cache(maxsize=8)
def domain(k: int, degree: int, device: str) -> Domain:
    """Per-(k, degree, device) Domain cache: the coset and vanishing tables
    are built once."""
    return Domain(k, degree, device)
