// X0 for one CUDA thread: the prover's field arithmetic (Montgomery
// product, add / sub / neg, the power chain, and the inversion by
// Bernstein-Yang divsteps) on the port's (16, *batch) int64 16-bit limb
// tensors, and the limb load and store that X1 (csrc/ntt.cu) shares.
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
// - inv: a mod p by five conditional subtractions of p (2^256 < 6p), its
//   inverse y by divsteps (below), then mont_mul(y, R^3 mod p). For a = x R
//   that is x^-1 R; for any a it is R^2 / a mod p, which is what the plain
//   chain mont_pow(a, p - 2) reaches (a^(p-2) R^-(p-3) = (a / R)^-1 R), and
//   0 for a = 0 mod p, as the chain gives.
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

// Eight words passed by value to a kernel (a constant such as R^3 mod p)
struct Words {
    uint32_t w[8];
};

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

// ---------------------------------------------------------------------------
// The inversion: Bernstein and Yang, "Fast constant-time gcd computation
// and modular inversion" (2019), as libsecp256k1's modinv32 implements it,
// with the paper's divstep (delta starting at 1):
//   (delta, f, g) -> (1 - delta, g, (g - f) / 2)        if delta > 0, g odd
//                    (1 + delta, f, (g + (g mod 2) f) / 2)  otherwise,
// from f = p, g = a (0 <= a < p). Numbers are 9 signed 30-bit limbs in
// 32-bit words (sum v_i 2^(30 i), limbs 0-7 in [0, 2^30) after an update,
// the top one signed). A batch runs 30 divsteps on the low words of f and g
// alone, tracking the 2 x 2 matrix T (entries in [-2^30, 2^30]) with
// 2^30 (f', g') = T (f, g); then (f, g) <- T (f, g) / 2^30 exactly, and
// (d, e) <- T (d, e) / 2^30 mod p, where d a = f and e a = g (mod p) hold
// throughout (d, e in (-2p, p)). By the paper's Theorem 11.2, g is 0 after
// m >= (49 d + 57) / 17 divsteps for f^2 + 4 g^2 <= 5 2^(2d), d = 254 here
// (p < 2^254 for Fr and Fq): m >= 735.5, so 25 batches of 30 (750), a fixed
// count, with no data-dependent branch (masks, as the Fermat chain had a
// fixed chain). Then f = +-1 and d = +-a^-1.
// ---------------------------------------------------------------------------

constexpr int DIVSTEP_BATCHES = 25;
constexpr int32_t M30 = (int32_t)(0xffffffffu >> 2);

struct S30 {
    int32_t v[9];
};

struct Trans {
    int32_t u, v, q, r;
};

// 8 words (a value below 2^256) -> 9 limbs of 30 bits
BN_HD void to_s30(S30& r, const uint32_t w[8]) {
    uint64_t acc = 0;
    int bits = 0, k = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        if (bits < 30 && k < 8) {
            acc |= (uint64_t)w[k++] << bits;
            bits += 32;
        }
        r.v[i] = (int32_t)(acc & (uint64_t)M30);
        acc >>= 30;
        bits -= 30;
    }
}

// 9 limbs of 30 bits (limbs in [0, 2^30), a value below 2^256) -> 8 words
BN_HD void from_s30(uint32_t w[8], const S30& a) {
    uint64_t acc = 0;
    int bits = 0, k = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        acc |= (uint64_t)(uint32_t)a.v[i] << bits;
        bits += 30;
        if (bits >= 32 && k < 8) {
            w[k++] = (uint32_t)acc;
            acc >>= 32;
            bits -= 32;
        }
    }
}

// 30 divsteps on the low words f0 (odd) and g0; eta = -delta. Returns the
// new eta, the matrix in t.
BN_HD int32_t divsteps_30(int32_t eta, uint32_t f0, uint32_t g0, Trans& t) {
    uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
#pragma unroll 6
    for (int i = 0; i < 30; ++i) {
        const uint32_t c1 = (uint32_t)(eta >> 31);  // all ones where delta > 0
        const uint32_t c2 = (uint32_t)0 - (g & 1u);  // all ones where g is odd
        const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
        g += x & c2;  // g - f or g + f where g is odd
        q += y & c2;
        r += z & c2;
        const uint32_t swap = c1 & c2;
        eta = (int32_t)(((uint32_t)eta ^ swap) - 1u + (swap & 1u));  // ~eta, or eta - 1
        f += g & swap;  // f + (g - f) = g
        u += q & swap;
        v += r & swap;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t.u = (int32_t)u;
    t.v = (int32_t)v;
    t.q = (int32_t)q;
    t.r = (int32_t)r;
    return eta;
}

// (d, e) <- T (d, e) / 2^30 mod p, kept in (-2p, p): multiples of p added
// so that the low 30 bits vanish, starting from [u, q] where d < 0 and
// [v, r] where e < 0 (libsecp256k1's update_de_30)
BN_HD void update_de(S30& d, S30& e, const Trans& t, const S30& p, uint32_t p_inv30) {
    const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
    int32_t md = (t.u & sd) + (t.v & se);
    int32_t me = (t.q & sd) + (t.r & se);
    int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
    int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
    md -= (int32_t)((p_inv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
    me -= (int32_t)((p_inv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
    cd += (int64_t)p.v[0] * md;
    ce += (int64_t)p.v[0] * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i] + (int64_t)p.v[i] * md;
        ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i] + (int64_t)p.v[i] * me;
        d.v[i - 1] = (int32_t)cd & M30;
        e.v[i - 1] = (int32_t)ce & M30;
        cd >>= 30;
        ce >>= 30;
    }
    d.v[8] = (int32_t)cd;
    e.v[8] = (int32_t)ce;
}

// (f, g) <- T (f, g) / 2^30, exact
BN_HD void update_fg(S30& f, S30& g, const Trans& t) {
    int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
    int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
        cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
        f.v[i - 1] = (int32_t)cf & M30;
        g.v[i - 1] = (int32_t)cg & M30;
        cf >>= 30;
        cg >>= 30;
    }
    f.v[8] = (int32_t)cf;
    g.v[8] = (int32_t)cg;
}

// d in (-2p, p) -> d mod p in [0, p), negated first where sign < 0
// (libsecp256k1's normalize_30)
BN_HD void normalize(S30& d, int32_t sign, const S30& p) {
    int32_t add = d.v[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] += p.v[i] & add;
    const int32_t neg = sign >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] = (d.v[i] ^ neg) - neg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d.v[i + 1] += d.v[i] >> 30;
        d.v[i] &= M30;
    }
    add = d.v[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] += p.v[i] & add;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d.v[i + 1] += d.v[i] >> 30;
        d.v[i] &= M30;
    }
}

// y = a^-1 mod p (0 for a = 0) for a < p, by DIVSTEP_BATCHES batches
template <class P>
BN_HD void divstep_inverse(uint32_t y[8], const uint32_t a[8]) {
    const uint32_t pw[8] = {P::mod(0), P::mod(1), P::mod(2), P::mod(3),
                            P::mod(4), P::mod(5), P::mod(6), P::mod(7)};
    S30 p, f, g, d, e;
    to_s30(p, pw);
    to_s30(g, a);
    f = p;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] = e.v[i] = 0;
    e.v[0] = 1;
    const uint32_t p_inv30 = (0u - P::INV) & (uint32_t)M30;  // p^-1 mod 2^30
    int32_t eta = -1;
    for (int b = 0; b < DIVSTEP_BATCHES; ++b) {
        Trans t;
        eta = divsteps_30(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
        update_de(d, e, t, p, p_inv30);
        update_fg(f, g, t);
    }
    normalize(d, f.v[8], p);
    from_s30(y, d);
}

// r = R^2 / a mod p (the Montgomery inverse of a = x R: x^-1 R), 0 for
// a = 0 mod p; a any value below 2^256, r3 = R^3 mod p
template <class P>
BN_HD void inv(uint32_t r[8], const uint32_t a[8], const uint32_t r3[8]) {
    uint32_t x[8], y[8];
    bn254::copy(x, a);
#pragma unroll
    for (int i = 0; i < 5; ++i) bnf::sub_if_ge<P>(x, x);
    divstep_inverse<P>(y, x);
    mont_mul<P>(r, y, r3);
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

template <class P>
BN_HD void inv_thread(const int64_t* a, int64_t* out, const Shape& s, const Strides& sa,
                      const uint32_t r3[8], uint32_t n, uint32_t t) {
    int64_t oa, unused;
    offsets(s, sa, sa, t, oa, unused);
    uint32_t x[8], r[8];
    load(x, a, sa.limb, oa);
    inv<P>(r, x, r3);
    store(out, n, t, r);
}

}  // namespace fops
