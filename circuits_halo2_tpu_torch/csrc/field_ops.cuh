// X0 and X1 for one CUDA thread: the prover's field arithmetic (Montgomery
// product, add / sub / neg, the power chain of a Fermat inversion) and one
// radix-2 butterfly, on the port's (16, *batch) int64 16-bit limb tensors.
//
// Every function here gives what the plain torch version in
// ops/field_torch.py gives, limb for limb, for any operands of value below
// 2^256, and not only where the public contract holds (canonical inputs, one
// product operand below p):
//
// - mont_mul / mont_sqr: the product S = a b is formed in full
//   (bnf::mul_wide / sqr_wide, exact for any a, b < 2^256) and Montgomery-
//   reduced by bnf::redc, whose word rounds need only S_lo < 2^256. The
//   result V = (S + m p) / 2^256, m = -S p^-1 mod 2^256, is the value the
//   plain limb-serial REDC reaches (m is unique mod 2^256, whatever the digit
//   size), and V < 2^256 + p. redc drops V's carry out of 2^256; it is
//   recovered as (V mod 2^256) < S_hi, and V - p is taken if V >= p: the
//   plain version's one conditional subtraction (_reduce_once). Where one
//   operand is below p, V < 2p and the result is canonical. So no operand
//   needs reducing first (bnf::mul's a, b < 2p is a bound on its lazy
//   output, not on its arithmetic).
// - add / sub: bn254::add / bn254::sub, which keep the carry of a + b and
//   the borrow of a - b exactly as the plain version's stacked candidates do.
// - neg: (p - a) mod 2^256, and 0 for a = 0.
// - pow: left-to-right square-and-multiply from 1 (Montgomery) over the
//   exponent's bits, MSB first, each step the exact product above, so every
//   intermediate is canonical and equals the plain loop's.
// - butterfly: (u, v) -> (u + w v, u - w v), the plain stage's three calls.
//
// Limbs are read as the value sum limb_i 2^(16 i) with the carries between
// limbs propagated, so a limb outside [0, 2^16) is read as the plain
// version's column sums read it; written limbs are normalised.
//
// Operand addressing: batch element t (row-major over the output's batch
// shape) of an operand lies at offset sum_d c_d stride_d, stride 0 on a
// broadcast axis, so a broadcast or strided view is read in place, never
// materialised.

#pragma once
#include "bn254_fast.cuh"

namespace fops {

constexpr int MAXD = 8;  // batch axes of an operand

// The output's batch shape and an operand's strides in int64 elements: the
// stride between limbs and one a batch axis (0 where it broadcasts).
struct Shape {
    int ndim;
    uint32_t size[MAXD];
};
struct Strides {
    int64_t limb;
    int64_t dim[MAXD];
};

// Offsets of batch element t in two operands (t < 2^32: an (16, *batch)
// int64 tensor of 2^32 elements would hold 512 GiB).
BN_HD void offsets(const Shape& s, const Strides& a, const Strides& b, uint32_t t,
                   int64_t& oa, int64_t& ob) {
    oa = ob = 0;
#pragma unroll
    for (int d = MAXD - 1; d > 0; --d) {
        if (d < s.ndim) {
            const uint32_t c = t % s.size[d];
            t /= s.size[d];
            oa += (int64_t)c * a.dim[d];
            ob += (int64_t)c * b.dim[d];
        }
    }
    if (s.ndim > 0) {
        oa += (int64_t)t * a.dim[0];
        ob += (int64_t)t * b.dim[0];
    }
}

// On the host, before a launch: the output's batch shape and two operands'
// strides from the wrapper's meta = [size[nd], a.limb, a.dim[nd], b.limb,
// b.dim[nd]], size-1 axes dropped and an axis merged into the one before it
// where the two are contiguous in both operands. False if the batch holds
// 2^31 elements or more.
static inline bool collapse(const int64_t* meta, int nd, Shape& s, Strides& a, Strides& b,
                            int64_t& n) {
    if (nd < 0 || nd > MAXD) return false;
    const int64_t* size = meta;
    const int64_t* sa = meta + nd + 1;
    const int64_t* sb = meta + 2 * nd + 2;
    a.limb = meta[nd];
    b.limb = meta[2 * nd + 1];
    n = 1;
    s.ndim = 0;
    for (int d = 0; d < nd; ++d) {
        if (size[d] < 0) return false;
        n *= size[d];
        if (size[d] == 1) continue;
        const int k = s.ndim - 1;
        if (k >= 0 && a.dim[k] == sa[d] * size[d] && b.dim[k] == sb[d] * size[d]) {
            s.size[k] *= (uint32_t)size[d];  // axis k runs on into axis d
            a.dim[k] = sa[d];
            b.dim[k] = sb[d];
        } else {
            s.size[s.ndim] = (uint32_t)size[d];
            a.dim[s.ndim] = sa[d];
            b.dim[s.ndim] = sb[d];
            ++s.ndim;
        }
    }
    return n < ((int64_t)1 << 31);
}

// 16 limbs at p[off + i * limb] -> 8 words of their value mod 2^256.
BN_HD void load(uint32_t w[8], const int64_t* p, int64_t limb, int64_t off) {
    int64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += p[off + 2 * k * limb];
        const uint32_t lo = (uint32_t)c & 0xffffu;
        c >>= 16;
        c += p[off + (2 * k + 1) * limb];
        w[k] = lo | (((uint32_t)c & 0xffffu) << 16);
        c >>= 16;
    }
}

BN_HD void store(int64_t* p, int64_t limb, int64_t off, const uint32_t w[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        p[off + 2 * k * limb] = w[k] & 0xffffu;
        p[off + (2 * k + 1) * limb] = w[k] >> 16;
    }
}

// 1 if a < b (as 256-bit integers), else 0
BN_HD uint32_t less(const uint32_t a[8], const uint32_t b[8]) {
    bnf::sub_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) bnf::subc_cc(a[i], b[i]);
    return bnf::subc(0, 0) & 1u;
}

// v = V mod 2^256 of V = redc + S_hi; r = V - p if V >= p, else V
template <class P>
BN_HD void finish(uint32_t r[8], const uint32_t v[8], const uint32_t s_hi[8]) {
    bn254::reduce_once<P>(r, v, less(v, s_hi));
}

template <class P>
BN_HD void mont_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t S[16], v[8];
    bnf::mul_wide(S, a, b);
    bnf::redc<P>(v, S);
    finish<P>(r, v, S + 8);
}

template <class P>
BN_HD void mont_sqr(uint32_t r[8], const uint32_t a[8]) {
    uint32_t S[16], v[8];
    bnf::sqr_wide(S, a);
    bnf::redc<P>(v, S);
    finish<P>(r, v, S + 8);
}

template <class P>
BN_HD void neg(uint32_t r[8], const uint32_t a[8]) {
    uint32_t d[8];
    d[0] = bnf::sub_cc(P::mod(0), a[0]);
#pragma unroll
    for (int i = 1; i < 7; ++i) d[i] = bnf::subc_cc(P::mod(i), a[i]);
    d[7] = bnf::subc(P::mod(7), a[7]);
    const uint32_t keep = bn254::is_zero(a) ? 0u : 0xffffffffu;
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = d[i] & keep;
}

enum LinearOp { OP_ADD = 0, OP_SUB = 1, OP_NEG = 2 };

template <class P>
BN_HD void linear(int op, uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    if (op == OP_ADD)
        bn254::add<P>(r, a, b);
    else if (op == OP_SUB)
        bn254::sub<P>(r, a, b);
    else
        neg<P>(r, a);
}

// The exponent: its bits MSB first from bit nbits - 1 (nbits >= 1; the
// plain loop runs over bin(e)[2:], one bit for e = 0).
struct Exponent {
    uint32_t w[8];
    int nbits;
};

// r = a^e in Montgomery form (1 for e = 0), a any value below 2^256
template <class P>
BN_HD void pow(uint32_t r[8], const uint32_t a[8], const Exponent& e) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = P::one(i);
    for (int i = e.nbits - 1; i >= 0; --i) {
        mont_sqr<P>(r, r);
        if ((e.w[i >> 5] >> (i & 31)) & 1u) mont_mul<P>(r, r, a);
    }
}

// One radix-2 DIT butterfly in place: (u, v) -> (u + w v, u - w v)
template <class P>
BN_HD void butterfly(uint32_t u[8], uint32_t v[8], const uint32_t w[8]) {
    uint32_t t[8];
    mont_mul<P>(t, v, w);
    bn254::sub<P>(v, u, t);
    bn254::add<P>(u, u, t);
}

// Butterfly j of stage s (half = 2^s) of an n-point row: its two positions
// in the row, q and q + half, and its twiddle's column in the (16, n - 1)
// table that holds stage s at columns half - 1 .. 2 half - 2.
BN_HD void butterfly_at(uint32_t j, int s, uint32_t& q, uint32_t& tw) {
    const uint32_t half = 1u << s;
    const uint32_t k = j & (half - 1);
    q = ((j >> s) << (s + 1)) + k;
    tw = half - 1 + k;
}

// ---------------------------------------------------------------------------
// One thread's work in each kernel (csrc/field_ops.cu), element t of the
// contiguous (16, n) output from operands at their strides
// ---------------------------------------------------------------------------

template <class P>
BN_HD void mont_mul_thread(const int64_t* a, const int64_t* b, int64_t* out, const Shape& s,
                           const Strides& sa, const Strides& sb, uint32_t n, uint32_t t) {
    int64_t oa, ob;
    offsets(s, sa, sb, t, oa, ob);
    uint32_t x[8], y[8], r[8];
    load(x, a, sa.limb, oa);
    load(y, b, sb.limb, ob);
    mont_mul<P>(r, x, y);
    store(out, n, t, r);
}

template <class P>
BN_HD void linear_thread(int op, const int64_t* a, const int64_t* b, int64_t* out,
                         const Shape& s, const Strides& sa, const Strides& sb, uint32_t n,
                         uint32_t t) {
    int64_t oa, ob;
    offsets(s, sa, sb, t, oa, ob);
    uint32_t x[8], y[8], r[8];
    load(x, a, sa.limb, oa);
    if (op != OP_NEG) load(y, b, sb.limb, ob);
    linear<P>(op, r, x, y);
    store(out, n, t, r);
}

template <class P>
BN_HD void pow_thread(const int64_t* a, int64_t* out, const Shape& s, const Strides& sa,
                      const Exponent& e, uint32_t n, uint32_t t) {
    int64_t oa, unused;
    offsets(s, sa, sa, t, oa, unused);
    uint32_t x[8], r[8];
    load(x, a, sa.limb, oa);
    pow<P>(r, x, e);
    store(out, n, t, r);
}

// Butterfly g of stage s over `rows` bit-reversed n = 2^logn point rows,
// in place on the contiguous (16, rows, n) x; tw the (16, n - 1) table.
BN_HD void ntt_thread(int64_t* x, const int64_t* tw, uint32_t rows, int logn, int s,
                      uint32_t g) {
    const uint32_t half_n = 1u << (logn - 1);
    uint32_t q, w;
    butterfly_at(g & (half_n - 1), s, q, w);
    const int64_t limb = (int64_t)rows << logn;
    const int64_t o = ((int64_t)(g >> (logn - 1)) << logn) + q;
    uint32_t u[8], v[8], wt[8];
    load(u, x, limb, o);
    load(v, x, limb, o + (1 << s));
    load(wt, tw, (int64_t)(2 * half_n - 1), w);
    butterfly<bn254::Fr>(u, v, wt);
    store(x, limb, o, u);
    store(x, limb, o + (1 << s), v);
}

}  // namespace fops
