// Lazy-reduced BN254 Fr / Fq arithmetic for one CUDA thread, on PTX carry
// chains: the field product of K1, K2 (poseidon.cu) and K3 (msm_scan.cu).
//
// An element is 8 little-endian 32-bit words in Montgomery form, R = 2^256,
// the domain of bn254.cuh and of the port's torch limbs. Both moduli are
// below 2^254 (top word 0x30644e72), so 4p < R, and every value here lives
// in [0, 2p); canon() makes one canonical where a caller needs it.
//
// - Products are separated operand scanning: the full 16-word product S is
//   formed, its low half Montgomery-reduced, u = (S_lo + m p) / R <= p, and
//   its high half added. For S < 4p^2 the high half is below 4p^2 / R
//   < 0.757 p, so u + S_hi < 2p: no final subtraction.
// - mul: a, b < 2p, so S = a b < 4p^2.
// - sqr: the 28 cross products are formed once and doubled, then the 8
//   squares are added: 36 word products instead of 64.
// - mul2: a0 b0 + a1 b1 with a < 2p and b < p (the MDS rows: canonical
//   constants), S < 4p^2, one reduction for the two products.
// - add / sub of two values below 2p end in one conditional subtraction /
//   addition of 2p (a + b < 4p < 2^256 never carries out).
//
// Every 32 x 32 word product is a mad.lo / madc.hi pair in a PTX carry
// chain (add.cc, addc, mad.lo.cc, madc.hi.cc, ...), so no 64-bit add is
// synthesised around it. The products of one row are split by the parity
// of their word (Emmart, Luitjens, Weems and Woolley, ARITH 2016): the
// even-word and the odd-word products of a row are each disjoint 64-bit
// pairs, so each parity is one chain of lo / hi halves, which ptxas turns
// into one IMAD.WIDE.U32(.X) per word product; the two accumulators are
// added once at the end. The Montgomery reduction keeps the same split
// word by word (redc below).
//
// Word products per operation (the multiply pipe's work; one IMAD.WIDE
// each, and the reduction's 8 quotient words one low-half IMAD each): mul
// 64 + 64 + 8, sqr 36 + 64 + 8, mul2 128 + 64 + 8; a CIOS product of
// bn254.cuh forms 64 + 64 + 8 as well, but as wide multiplies and 64-bit
// adds, and canonicalises after every product.
//
// On the host (BN_HD as plain C++, for the g++ harness of the tests) each
// carry-chain primitive is a C++ twin that keeps the carry flag in a
// variable, so the host runs the same algorithm: the same word order, the
// same chains and the same lazy bounds.

#pragma once
#include "bn254.cuh"

namespace bnf {

// ---------------------------------------------------------------------------
// Carry-chain primitives
// ---------------------------------------------------------------------------

#ifndef __CUDA_ARCH__
static uint32_t host_cf;  // the host twin of the carry flag CC.CF
#endif

#ifdef __CUDA_ARCH__
#define BNF_PTX2(op, a, b)                                                   \
    uint32_t r;                                                              \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));              \
    return r
#define BNF_PTX3(op, a, b, c)                                                \
    uint32_t r;                                                              \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));  \
    return r
#endif

// host twin: r = x + y + carry-in, carry-out kept when `keep`
#ifndef __CUDA_ARCH__
static inline uint32_t host_sum(uint64_t x, uint64_t y, uint32_t cin, bool keep) {
    const uint64_t s = x + y + cin;
    if (keep) host_cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
}
static inline uint32_t host_diff(uint32_t x, uint32_t y, uint32_t bin, bool keep) {
    const uint64_t d = (uint64_t)x - y - bin;
    if (keep) host_cf = (uint32_t)(d >> 63);  // borrow
    return (uint32_t)d;
}
static inline uint32_t lo(uint32_t a, uint32_t b) { return a * b; }
static inline uint32_t hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
#endif

#ifdef __CUDA_ARCH__
#define BNF_OP2(name, ptx, host) \
    BN_HD uint32_t name(uint32_t a, uint32_t b) { BNF_PTX2(ptx, a, b); }
#define BNF_OP3(name, ptx, host) \
    BN_HD uint32_t name(uint32_t a, uint32_t b, uint32_t c) { BNF_PTX3(ptx, a, b, c); }
#else
#define BNF_OP2(name, ptx, host) \
    BN_HD uint32_t name(uint32_t a, uint32_t b) { return host; }
#define BNF_OP3(name, ptx, host) \
    BN_HD uint32_t name(uint32_t a, uint32_t b, uint32_t c) { return host; }
#endif

BNF_OP2(add_cc, "add.cc.u32", host_sum(a, b, 0, true))
BNF_OP2(addc_cc, "addc.cc.u32", host_sum(a, b, host_cf, true))
BNF_OP2(addc, "addc.u32", host_sum(a, b, host_cf, false))
BNF_OP2(sub_cc, "sub.cc.u32", host_diff(a, b, 0, true))
BNF_OP2(subc_cc, "subc.cc.u32", host_diff(a, b, host_cf, true))
BNF_OP2(subc, "subc.u32", host_diff(a, b, host_cf, false))
BNF_OP3(mad_lo_cc, "mad.lo.cc.u32", host_sum(lo(a, b), c, 0, true))
BNF_OP3(madc_lo_cc, "madc.lo.cc.u32", host_sum(lo(a, b), c, host_cf, true))
BNF_OP3(madc_hi_cc, "madc.hi.cc.u32", host_sum(hi(a, b), c, host_cf, true))

#undef BNF_OP2
#undef BNF_OP3

// ---------------------------------------------------------------------------
// Moduli: p (from bn254.cuh) and 2p
// ---------------------------------------------------------------------------

template <class P> struct Twice;
template <> struct Twice<bn254::Fr> {
    BN_HD uint32_t mod(int i) {
        const uint32_t m[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                               0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
        return m[i];
    }
};
template <> struct Twice<bn254::Fq> {
    BN_HD uint32_t mod(int i) {
        const uint32_t m[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                               0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
        return m[i];
    }
};

// ---------------------------------------------------------------------------
// Additive operations on [0, 2p)
// ---------------------------------------------------------------------------

// r = a + m for an 8-word constant m (wraps mod 2^256)
template <class M>
BN_HD void add_const(uint32_t r[8], const uint32_t a[8], uint32_t mask) {
    r[0] = add_cc(a[0], M::mod(0) & mask);
#pragma unroll
    for (int i = 1; i < 7; ++i) r[i] = addc_cc(a[i], M::mod(i) & mask);
    r[7] = addc(a[7], M::mod(7) & mask);
}

// r = s - m if s >= m else s (s < 2m)
template <class M>
BN_HD void sub_if_ge(uint32_t r[8], const uint32_t s[8]) {
    uint32_t d[8];
    d[0] = sub_cc(s[0], M::mod(0));
#pragma unroll
    for (int i = 1; i < 8; ++i) d[i] = subc_cc(s[i], M::mod(i));
    const uint32_t keep = subc(0, 0);  // all ones where s < m
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = (s[i] & keep) | (d[i] & ~keep);
}

// a, b < 2p -> r = a + b mod p, r < 2p
template <class P>
BN_HD void add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t s[8];
    s[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 7; ++i) s[i] = addc_cc(a[i], b[i]);
    s[7] = addc(a[7], b[7]);
    sub_if_ge<Twice<P>>(r, s);
}

// a, b < 2p -> r = a - b mod p, r < 2p
template <class P>
BN_HD void sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t d[8];
    d[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) d[i] = subc_cc(a[i], b[i]);
    const uint32_t borrow = subc(0, 0);
    add_const<Twice<P>>(r, d, borrow);
}

template <class P>
BN_HD void dbl(uint32_t r[8], const uint32_t a[8]) {
    add<P>(r, a, a);
}

// a < 2p -> the canonical r = a mod p
template <class P>
BN_HD void canon(uint32_t r[8], const uint32_t a[8]) {
    sub_if_ge<P>(r, a);
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

BN_HD uint32_t mul_hi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    return __umulhi(a, b);
#else
    return hi(a, b);
#endif
}

// How a chain of products ends: SET writes the products (no carries);
// FRESH writes the carry out into acc[2C]; ACC adds it there (acc[2C] was
// written before and stays below 2^32 - 1).
enum Tail { SET, FRESH, ACC };

// acc[0 .. 2C) += y * x[2k] for k < C: C disjoint 64-bit products, low and
// high halves alternating in one carry chain, which ptxas fuses into
// IMAD.WIDE.U32(.X), one instruction per word product.
template <int C, Tail T>
BN_HD void pairs(uint32_t* acc, const uint32_t* x, uint32_t y) {
    if (T == SET) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
            acc[2 * k] = x[2 * k] * y;
            acc[2 * k + 1] = mul_hi(x[2 * k], y);
        }
        return;
    }
    acc[0] = mad_lo_cc(x[0], y, acc[0]);
    acc[1] = madc_hi_cc(x[0], y, acc[1]);
#pragma unroll
    for (int k = 1; k < C; ++k) {
        acc[2 * k] = madc_lo_cc(x[2 * k], y, acc[2 * k]);
        acc[2 * k + 1] = madc_hi_cc(x[2 * k], y, acc[2 * k + 1]);
    }
    if (T == FRESH) acc[2 * C] = addc(0, 0);
    if (T == ACC) acc[2 * C] = addc(acc[2 * C], 0);
}

// S = ev + od * 2^32 (od[15] is 0: od * 2^32 <= S < 2^512)
BN_HD void merge(uint32_t S[16], const uint32_t ev[16], const uint32_t od[16]) {
    S[0] = ev[0];
    S[1] = add_cc(ev[1], od[0]);
#pragma unroll
    for (int k = 2; k < 15; ++k) S[k] = addc_cc(ev[k], od[k - 1]);
    S[15] = addc(ev[15], od[14]);
}

// S = a * b (16 words). Even and odd words of a accumulate apart (ev at
// word 0, od at word 1), so each row is two chains of disjoint products.
// Row i adds into words i .. i+7 of each array, whose word i+7 holds the
// carry of row i-1, and carries into the fresh word i+8; every partial sum
// is at most a * b, so no carry leaves the 16 words.
BN_HD void mul_wide(uint32_t S[16], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t ev[16], od[16];
    pairs<4, SET>(ev, a, b[0]);
    pairs<4, SET>(od, a + 1, b[0]);
    ev[8] = od[8] = 0;
#pragma unroll
    for (int i = 1; i < 8; ++i) {
        pairs<4, FRESH>(ev + i, a, b[i]);
        pairs<4, FRESH>(od + i, a + 1, b[i]);
    }
    merge(S, ev, od);
}

// S = a0 * b0 + a1 * b1: the rows of the two products interleaved, the
// second adding its carry to the first's (together below 2^(32(i+9))).
BN_HD void mul2_wide(uint32_t S[16], const uint32_t a0[8], const uint32_t b0[8],
                     const uint32_t a1[8], const uint32_t b1[8]) {
    uint32_t ev[16], od[16];
    pairs<4, SET>(ev, a0, b0[0]);
    pairs<4, SET>(od, a0 + 1, b0[0]);
    ev[8] = od[8] = 0;
    pairs<4, ACC>(ev, a1, b1[0]);
    pairs<4, ACC>(od, a1 + 1, b1[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) {
        pairs<4, FRESH>(ev + i, a0, b0[i]);
        pairs<4, FRESH>(od + i, a0 + 1, b0[i]);
        pairs<4, ACC>(ev + i, a1, b1[i]);
        pairs<4, ACC>(od + i, a1 + 1, b1[i]);
    }
    merge(S, ev, od);
}

// S = a^2: the 28 cross products a_i a_j (i < j) once, doubled, plus the 8
// squares. A cross product at word s = i + j goes to ev[s] (s even) or
// od[s - 1] (s odd); row i is one chain in each. Both arrays start at 0;
// a row's chain runs over its product words and ends in a word that holds
// at most one earlier carry (so at most 2), above which nothing is written
// yet, so no carry is lost.
BN_HD void sqr_wide(uint32_t S[16], const uint32_t a[8]) {
    uint32_t ev[16], od[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) ev[k] = od[k] = 0;
    pairs<4, ACC>(od + 0, a + 1, a[0]);  // j = 1, 3, 5, 7
    pairs<3, ACC>(ev + 2, a + 2, a[0]);  // j = 2, 4, 6
    pairs<3, ACC>(od + 2, a + 2, a[1]);
    pairs<3, ACC>(ev + 4, a + 3, a[1]);
    pairs<3, ACC>(od + 4, a + 3, a[2]);
    pairs<2, ACC>(ev + 6, a + 4, a[2]);
    pairs<2, ACC>(od + 6, a + 4, a[3]);
    pairs<2, ACC>(ev + 8, a + 5, a[3]);
    pairs<2, ACC>(od + 8, a + 5, a[4]);
    pairs<1, ACC>(ev + 10, a + 6, a[4]);
    pairs<1, ACC>(od + 10, a + 6, a[5]);
    pairs<1, ACC>(ev + 12, a + 7, a[5]);
    pairs<1, ACC>(od + 12, a + 7, a[6]);
    merge(S, ev, od);
    // double the cross products (2 * cross < a^2 fits), add the squares
    S[1] = add_cc(S[1], S[1]);
#pragma unroll
    for (int k = 2; k < 15; ++k) S[k] = addc_cc(S[k], S[k]);
    S[15] = addc(S[15], S[15]);
    S[0] = mad_lo_cc(a[0], a[0], S[0]);
    S[1] = madc_hi_cc(a[0], a[0], S[1]);
#pragma unroll
    for (int i = 1; i < 8; ++i) {
        S[2 * i] = madc_lo_cc(a[i], a[i], S[2 * i]);
        S[2 * i + 1] = madc_hi_cc(a[i], a[i], S[2 * i + 1]);
    }
}

// r = S * 2^-256 mod p, r < 2p, for S < 4p^2: the low half Montgomery-
// reduced word by word, then the high half added.
//
// Round k turns A into (A + m p) / 2^32, m = A * (-p^-1) mod 2^32, starting
// from A = S_lo < 2^256; A stays below 2^256 and ends at most p. A is held
// as x + y * 2^32, so x[0] is A's low word and m p splits into two chains
// of disjoint products like a row of mul_wide: z = x + (even words of m p),
// whose word 0 becomes 0, and w = y + (odd words of m p). The next A is
// (z + w * 2^32) / 2^32 = (w + z1) + (z >> 64) * 2^32: w, with z's word 1
// folded into its word 0, takes x's role, and z shifted down two words
// takes y's, the fold's carry running on into y's chain (same word). Every
// x is at most A < 2^256 (its word 8 is 0) and every y below 2^288.
template <class P>
BN_HD void redc(uint32_t r[8], const uint32_t S[16]) {
    const uint32_t p[8] = {P::mod(0), P::mod(1), P::mod(2), P::mod(3),
                           P::mod(4), P::mod(5), P::mod(6), P::mod(7)};
    uint32_t x[9], y[9];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = S[i];
    x[8] = 0;
    uint32_t m = x[0] * P::INV;
    pairs<4, SET>(y, p + 1, m);
    y[8] = 0;
    pairs<4, FRESH>(x, p, m);
    // x is z (x[0] == 0), y is w
#pragma unroll
    for (int k = 1; k < 8; ++k) {
        uint32_t n[9];
        y[0] = add_cc(y[0], x[1]);
        m = y[0] * P::INV;
        n[0] = madc_lo_cc(m, p[1], x[2]);
        n[1] = madc_hi_cc(m, p[1], x[3]);
        n[2] = madc_lo_cc(m, p[3], x[4]);
        n[3] = madc_hi_cc(m, p[3], x[5]);
        n[4] = madc_lo_cc(m, p[5], x[6]);
        n[5] = madc_hi_cc(m, p[5], x[7]);
        n[6] = madc_lo_cc(m, p[7], x[8]);
        n[7] = madc_hi_cc(m, p[7], 0);
        n[8] = addc(0, 0);
        pairs<4, ACC>(y, p, m);
#pragma unroll
        for (int i = 0; i < 9; ++i) {
            x[i] = y[i];
            y[i] = n[i];
        }
    }
    // A = y + (x >> 32) < 2^256 (y[8] is 0), then r = A + S_hi < 2p
    uint32_t t[8];
    t[0] = add_cc(y[0], x[1]);
#pragma unroll
    for (int i = 1; i < 7; ++i) t[i] = addc_cc(y[i], x[i + 1]);
    t[7] = addc(y[7], x[8]);
    r[0] = add_cc(t[0], S[8]);
#pragma unroll
    for (int i = 1; i < 7; ++i) r[i] = addc_cc(t[i], S[8 + i]);
    r[7] = addc(t[7], S[15]);
}

// a, b < 2p -> r = a b R^-1 mod p, r < 2p (r may alias a or b)
template <class P>
BN_HD void mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t S[16];
    mul_wide(S, a, b);
    redc<P>(r, S);
}

// a < 2p -> r = a^2 R^-1 mod p, r < 2p
template <class P>
BN_HD void sqr(uint32_t r[8], const uint32_t a[8]) {
    uint32_t S[16];
    sqr_wide(S, a);
    redc<P>(r, S);
}

// a0, a1 < 2p, b0, b1 < p -> r = (a0 b0 + a1 b1) R^-1 mod p, r < 2p
template <class P>
BN_HD void mul2(uint32_t r[8], const uint32_t a0[8], const uint32_t b0[8],
                const uint32_t a1[8], const uint32_t b1[8]) {
    uint32_t S[16];
    mul2_wide(S, a0, b0, a1, b1);
    redc<P>(r, S);
}

}  // namespace bnf
