"""BN254 Fr / Fq Montgomery arithmetic on torch limb tensors.

Counterpart of ``circuits_halo2_tpu/ops/field_jax.py`` with the same layout:
a field element is 16 little-endian 16-bit limbs, limbs leading, so a batch
is a ``(16, *batch)`` tensor. The dtype is int64 (torch's CPU uint32 has no
add or shift), which leaves 47 bits of headroom per limb: column sums of
limb products are accumulated without intermediate carries, and one
sequential carry pass normalises them.

Montgomery form uses R = 2^256. Every public function takes and returns
canonical limbs (< p); kernels choose their own layout and their wrappers
convert at this boundary.

On a CUDA tensor the product (and ``mont_sqr``, ``to_mont``, ``from_mont``,
``pow5``, which call it), add / sub / neg, the inversion and the power
chain each launch one hand-written kernel of ``csrc/field_ops.cu`` (X0a
``mont_mul``, X0b ``linear``, X0c ``inv_mont``, a divstep inversion, and
``mont_pow``), which reads the operands through their strides (a broadcast
or strided view is never materialised) and writes a contiguous (16, *batch)
result; a failed build or launch raises. On a CPU tensor, or inside
``plain()``, they run the plain versions (``*_ref``; the inversion's is the
Fermat chain ``mont_pow_ref(a, p - 2)``), which give the same limbs.

The plain multiply never builds the (16, 16, *batch) outer product: product
columns are accumulated one limb row at a time (``addcmul_``), and the
Montgomery reduction runs limb-serially on the same 32-column buffer, so
the working set is ~2x the output.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from .. import build
from . import field as F

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = 0xFFFF
DTYPE = torch.int64


# ---------------------------------------------------------------------------
# Host conversions
# ---------------------------------------------------------------------------

def int_to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """One integer -> (nlimbs,) int64 little-endian 16-bit limbs."""
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)], dtype=np.int64
    )


def ints_to_limbs(xs, nlimbs: int = NLIMBS) -> np.ndarray:
    """Sequence of non-negative ints (< 2^256) -> (nlimbs, len(xs)) int64."""
    if len(xs) == 0:
        return np.empty((nlimbs, 0), dtype=np.int64)
    buf = b"".join(int(x).to_bytes(nlimbs * 2, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(xs), nlimbs)
    return np.ascontiguousarray(arr.T).astype(np.int64)


def limbs_to_int(limbs) -> int:
    arr = _as_numpy(limbs)
    return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(arr.shape[0]))


def limbs_to_ints(limbs) -> list[int]:
    """(nlimbs, N) normalised limbs -> list of N ints."""
    arr = np.ascontiguousarray(_as_numpy(limbs).T.astype("<u2"))
    if arr.shape[0] == 0:
        return []
    step = arr.shape[1] * 2
    buf = arr.tobytes()
    return [
        int.from_bytes(buf[i * step : (i + 1) * step], "little")
        for i in range(arr.shape[0])
    ]


def _as_numpy(limbs) -> np.ndarray:
    if isinstance(limbs, torch.Tensor):
        return limbs.detach().cpu().numpy()
    return np.asarray(limbs)


class FieldSpec:
    """Per-field constants (host ints and limb arrays)."""

    def __init__(self, name: str, mod: int):
        self.name = name
        self.mod_int = mod
        self.mod = int_to_limbs(mod)
        self.r2 = int_to_limbs((1 << 512) % mod)
        self.one_mont = int_to_limbs((1 << 256) % mod)
        # -p^{-1} mod 2^16: the per-limb Montgomery factor
        self.n0 = (-pow(mod, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.r_inv = pow(1 << 256, -1, mod)

    def const(self, value: int, mont: bool = True) -> np.ndarray:
        """Embed a host integer as (16, 1) limbs, optionally in Montgomery form."""
        v = value % self.mod_int
        if mont:
            v = (v << 256) % self.mod_int
        return int_to_limbs(v).reshape((NLIMBS, 1))

    def __repr__(self) -> str:
        return f"FieldSpec({self.name})"


FR = FieldSpec("fr", F.FR_MOD)
FQ = FieldSpec("fq", F.FQ_MOD)


@functools.lru_cache(maxsize=None)
def _const_cached(values: tuple, device: str, ndim: int) -> torch.Tensor:
    t = torch.tensor(values, dtype=DTYPE, device=device)
    return t.reshape((NLIMBS,) + (1,) * (ndim - 1))


def const_tensor(limbs: np.ndarray, device, ndim: int) -> torch.Tensor:
    """A (16,) limb constant as a cached (16, 1, ..., 1) tensor on ``device``."""
    return _const_cached(tuple(int(v) for v in np.asarray(limbs).reshape(-1)),
                         str(torch.device(device)), ndim)


def to_mont_limbs(values, spec: FieldSpec = FR) -> np.ndarray:
    """Host ints -> (16, n) canonical Montgomery limbs (host numpy)."""
    p = spec.mod_int
    return ints_to_limbs([((v % p) << 256) % p for v in values])


def from_mont_ints(limbs, spec: FieldSpec = FR) -> list[int]:
    """(16, n) Montgomery limbs -> canonical host ints."""
    p, r_inv = spec.mod_int, spec.r_inv
    return [v * r_inv % p for v in limbs_to_ints(limbs)]


def limbs_to_words(limbs: torch.Tensor, dim: int) -> torch.Tensor:
    """16 x 16-bit int64 limbs along ``dim`` -> 8 x 32-bit words as int32
    (the bit pattern a kernel reads as uint32), contiguous."""
    lo = limbs.narrow(dim, 0, NLIMBS).unfold(dim, 2, 2)
    w = lo.select(-1, 0) | (lo.select(-1, 1) << LIMB_BITS)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).contiguous()


def words_to_limbs(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of ``limbs_to_words``: int32 words along ``dim`` -> int64 limbs."""
    w = words.to(DTYPE) & 0xFFFFFFFF
    return torch.stack([w & LIMB_MASK, w >> LIMB_BITS], dim=dim + 1).flatten(dim, dim + 1)


# ---------------------------------------------------------------------------
# Carry handling
# ---------------------------------------------------------------------------

def normalize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed column sums -> exact 16-bit limbs plus the carry out of the top.

    x: (k, *batch) int64, modified in place. Arithmetic right shifts make
    negative columns borrow correctly, so ``carry`` is the floor of
    value / 2^(16k) and may be negative."""
    k = x.shape[0]
    for i in range(k - 1):
        x[i + 1] += x[i] >> LIMB_BITS
    carry = x[k - 1] >> LIMB_BITS
    x &= LIMB_MASK
    return x, carry


def _reduce_once(raw: torch.Tensor, mod: torch.Tensor) -> torch.Tensor:
    """raw: (16, *batch) signed columns with value V in [0, 2p) -> V mod p.

    Both candidates V and V - p are normalised in one pass (stacked on a
    new axis 1); the sign of the second's carry selects."""
    both = torch.stack([raw, raw - mod], dim=1)
    limbs, carry = normalize(both)
    return torch.where(carry[1] >= 0, limbs[:, 1], limbs[:, 0])


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def mont_mul_ref(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """Montgomery product a·b·2^-256 mod p on (16, *batch) limbs.

    One operand must be < p and the other < 2^256; the result is canonical."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    ndim = len(batch) + 1
    mod = const_tensor(spec.mod, a.device, ndim)
    t = torch.zeros((2 * NLIMBS,) + tuple(batch), dtype=DTYPE, device=a.device)
    for i in range(NLIMBS):  # product columns, < 16·2^32 each
        t[i : i + NLIMBS].addcmul_(a[i : i + 1], b)
    n0 = spec.n0
    for i in range(NLIMBS):  # limb-serial REDC: clear column i, carry up
        m = (t[i] * n0) & LIMB_MASK  # t[i] < 2^38: the product fits int64
        t[i : i + NLIMBS].addcmul_(m.unsqueeze(0), mod)
        t[i + 1] += t[i] >> LIMB_BITS
    # value of t[16:32] (plus its own carries) is < 2p
    return _reduce_once(t[NLIMBS : 2 * NLIMBS], mod)


def add_mod_ref(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """(a + b) mod p for canonical inputs; works in either domain."""
    raw = a + b
    return _reduce_once(raw, const_tensor(spec.mod, a.device, raw.dim()))


def sub_mod_ref(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """(a - b) mod p."""
    raw = a - b
    mod = const_tensor(spec.mod, a.device, raw.dim())
    both = torch.stack([raw, raw + mod], dim=1)
    limbs, carry = normalize(both)
    return torch.where(carry[0] >= 0, limbs[:, 0], limbs[:, 1])


def neg_mod_ref(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """p - a, with 0 -> 0."""
    mod = const_tensor(spec.mod, a.device, a.dim())
    diff, _ = normalize(mod - a)
    return torch.where(is_zero(a).unsqueeze(0), torch.zeros_like(a), diff)


def mont_pow_ref(a: torch.Tensor, exponent: int, spec: FieldSpec = FR) -> torch.Tensor:
    """Fixed-exponent power by left-to-right square-and-multiply."""
    one = const_tensor(spec.one_mont, a.device, a.dim())
    result = one.expand_as(a).clone()
    for bit in bin(exponent)[2:]:
        result = mont_mul_ref(result, result, spec)
        if bit == "1":
            result = mont_mul_ref(result, a, spec)
    return result


# ---------------------------------------------------------------------------
# Dispatch: the kernels (X0, csrc/field_ops.cu) on a CUDA tensor, the
# plain versions on a CPU tensor or inside ``plain()``
# ---------------------------------------------------------------------------

_mode = threading.local()


@contextlib.contextmanager
def plain():
    """Inside the block the field operations run their plain versions on
    every device. The plain versions of the other kernels (and ``ntt_ref``)
    run in it, so that a kernel is held against plain torch on the card and
    not against X0."""
    depth = getattr(_mode, "plain", 0)
    _mode.plain = depth + 1
    try:
        yield
    finally:
        _mode.plain = depth


def plain_version(fn):
    """Decorator: ``fn`` runs inside ``plain()``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with plain():
            return fn(*args, **kwargs)

    return wrapped


def on_card(a) -> bool:
    """Whether an operation on ``a`` launches its kernel: a CUDA tensor
    outside ``plain()``. A CPU tensor runs the plain version; any other
    device raises."""
    kind = a.device.type
    if kind == "cpu" or getattr(_mode, "plain", 0):
        return False
    if kind != "cuda":
        raise ValueError(f"field_torch: unsupported device {a.device}")
    return True


MAX_BATCH_DIMS = 8  # csrc/field_ops.cuh MAXD
_FIELD_CODES = {F.FR_MOD: 0, F.FQ_MOD: 1}


def strides_meta(*xs: torch.Tensor) -> tuple[tuple, list[int]]:
    """The operands' broadcast batch shape, and what ``csrc/field_ops.cuh``
    reads of them: that shape, then each operand's limb stride and batch
    strides in elements (0 on an axis it broadcasts over, missing leading
    axes included)."""
    batch = tuple(torch.broadcast_shapes(*(x.shape[1:] for x in xs)))
    meta = list(batch)
    for x in xs:
        st, shape = x.stride(), x.shape
        meta.append(st[0])
        meta += [0] * (len(batch) + 1 - x.dim())
        meta += [0 if shape[d] == 1 else st[d] for d in range(1, x.dim())]
    return batch, meta


def _launch_args(name: str, spec: FieldSpec, *xs: torch.Tensor):
    """Checks the operands, builds the library, and returns it with the
    output (16, *batch), ``strides_meta`` as a C array, the field code and
    the stream."""
    for x in xs:
        if x.dtype != DTYPE or x.dim() < 1 or x.shape[0] != NLIMBS:
            raise ValueError(f"{name}: operands must be (16, ...) int64 limb tensors")
        if x.device != xs[0].device:
            raise ValueError(f"{name}: operands on {x.device} and {xs[0].device}")
    if spec.mod_int not in _FIELD_CODES:
        raise ValueError(f"{name}: no kernel for {spec}")
    lib = build.cuda_library()
    batch, meta = strides_meta(*xs)
    if len(batch) > MAX_BATCH_DIMS:
        raise ValueError(f"{name}: more than {MAX_BATCH_DIMS} batch axes")
    out = torch.empty((NLIMBS,) + batch, dtype=DTYPE, device=xs[0].device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    return lib, out, (ctypes.c_int64 * len(meta))(*meta), _FIELD_CODES[spec.mod_int], stream


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """Montgomery product a·b·2^-256 mod p on (16, *batch) limbs, the
    operands broadcast over the batch axes. One operand must be < p and the
    other < 2^256; the result is canonical. X0a on a CUDA tensor."""
    if not on_card(a):
        return mont_mul_ref(a, b, spec)
    lib, out, meta, field, stream = _launch_args("mont_mul", spec, a, b)
    if out.numel():
        mont_mul.launches += 1
        build.check(lib.field_mont_mul_cuda(a.data_ptr(), b.data_ptr(), out.data_ptr(), meta,
                                            out.dim() - 1, field, stream), "field_mont_mul_cuda")
    return out


mont_mul.launches = 0

ADD, SUB, NEG = 0, 1, 2  # linear's op codes (csrc/field_ops.cuh LinearOp)


def linear(op: int, a: torch.Tensor, b: torch.Tensor | None, spec: FieldSpec = FR) -> torch.Tensor:
    """a + b, a - b or -a mod p (``ADD``, ``SUB``, ``NEG``; b unused for
    ``NEG``), broadcast over the batch axes. X0b on a CUDA tensor."""
    if op not in (ADD, SUB, NEG):
        raise ValueError(f"linear: unknown op {op}")
    if not on_card(a):
        if op == ADD:
            return add_mod_ref(a, b, spec)
        if op == SUB:
            return sub_mod_ref(a, b, spec)
        return neg_mod_ref(a, spec)
    b = a if op == NEG else b
    lib, out, meta, field, stream = _launch_args("linear", spec, a, b)
    if out.numel():
        linear.launches += 1
        build.check(lib.field_linear_cuda(op, a.data_ptr(), b.data_ptr(), out.data_ptr(), meta,
                                          out.dim() - 1, field, stream), "field_linear_cuda")
    return out


linear.launches = 0


def add_mod(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """(a + b) mod p for canonical inputs; works in either domain."""
    return linear(ADD, a, b, spec)


def sub_mod(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """(a - b) mod p."""
    return linear(SUB, a, b, spec)


def neg_mod(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """p - a, with 0 -> 0."""
    return linear(NEG, a, None, spec)


def mont_sqr(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    return mont_mul(a, a, spec)


def to_mont(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """Plain limbs (< 2^256, any residue) -> canonical Montgomery form."""
    return mont_mul(a, const_tensor(spec.r2, a.device, a.dim()), spec)


def from_mont(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    one = const_tensor(int_to_limbs(1), a.device, a.dim())
    return mont_mul(a, one, spec)


def pow5(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """x^5 in Montgomery form (the Poseidon S-box)."""
    a2 = mont_mul(a, a, spec)
    a4 = mont_mul(a2, a2, spec)
    return mont_mul(a4, a, spec)


def mont_pow(a: torch.Tensor, exponent: int, spec: FieldSpec = FR) -> torch.Tensor:
    """Fixed-exponent power by left-to-right square-and-multiply; on a CUDA
    tensor the whole chain in one launch (0 <= exponent < 2^256)."""
    if not on_card(a):
        return mont_pow_ref(a, exponent, spec)
    if not 0 <= exponent < 1 << 256:
        raise ValueError("mont_pow: the kernel takes exponents in [0, 2^256)")
    lib, out, meta, field, stream = _launch_args("mont_pow", spec, a, a)
    if out.numel():
        words = (ctypes.c_uint32 * 8)(*((exponent >> (32 * i)) & 0xFFFFFFFF for i in range(8)))
        mont_pow.launches += 1
        build.check(lib.field_pow_cuda(a.data_ptr(), out.data_ptr(), meta, out.dim() - 1, words,
                                       max(1, exponent.bit_length()), field, stream),
                    "field_pow_cuda")
    return out


mont_pow.launches = 0


def inv_mont(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """The Montgomery inverse, the Fermat chain's result a^(p-2) (R^2 / a
    mod p for any limbs below 2^256; zero maps to zero). X0c on a CUDA
    tensor: a Bernstein-Yang divstep inversion, a fixed 750 divsteps (the
    whole batch in one launch); on a CPU tensor the plain chain."""
    if not on_card(a):
        return mont_pow_ref(a, spec.mod_int - 2, spec)
    lib, out, meta, field, stream = _launch_args("inv_mont", spec, a, a)
    if out.numel():
        inv_mont.launches += 1
        build.check(lib.field_inv_cuda(a.data_ptr(), out.data_ptr(), meta, out.dim() - 1,
                                       _r3_words(spec.mod_int), field, stream), "field_inv_cuda")
    return out


@functools.lru_cache(maxsize=None)
def _r3_words(mod: int):
    """R^3 mod p as a C array of 8 words, the factor that restores the
    Montgomery form after X0c's inversion (made once a field)."""
    r3 = (1 << 768) % mod
    return (ctypes.c_uint32 * 8)(*((r3 >> (32 * i)) & 0xFFFFFFFF for i in range(8)))


inv_mont.launches = 0


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field select: mask ? a : b.  mask: (*batch,) bool."""
    return torch.where(mask.unsqueeze(0), a, b)
