// BN254 G1 in Jacobian coordinates for one CUDA thread, on the lazy Fq
// arithmetic of bn254_fast.cuh: the doubling of K3 (msm_scan.cu) and X4
// (ec_fft.cu), X4's complete addition, and the reference's double-and-add by
// a plain scalar. A point is three 8-word Montgomery Fq coordinates; Z = 0 is
// the point at infinity. Every function takes and returns canonical words,
// and follows the formulas and the case selection of the plain torch version
// (ops/msm.py) step for step, so the outputs are equal limb for limb.
// Per-thread code only (BN_HD): the g++ harness of the tests runs it too.
//
// The complete addition reads its operands from memory (a PointRef: shared
// memory in X4's kernels) coordinate by coordinate where the formula needs
// them, through volatile loads that the compiler neither merges nor hoists,
// so that no input point stays live in registers across the formula.

#pragma once
#include "bn254_fast.cuh"

namespace g1 {

using bn254::Fq;

// dbl-2009-l (ops/msm.py::jac_double), a = 0 curve; canonical in and out.
BN_HD void jac_double(uint32_t x3[8], uint32_t y3[8], uint32_t z3[8],
                      const uint32_t x[8], const uint32_t y[8], const uint32_t z[8]) {
    uint32_t a[8], b[8], c[8], xb[8], d[8], e[8], f[8], t[8], c8[8];
    bnf::sqr<Fq>(a, x);
    bnf::sqr<Fq>(b, y);
    bnf::sqr<Fq>(c, b);
    bnf::add<Fq>(xb, x, b);
    bnf::sqr<Fq>(t, xb);
    bnf::sub<Fq>(t, t, a);
    bnf::sub<Fq>(d, t, c);
    bnf::dbl<Fq>(d, d);
    bnf::add<Fq>(e, a, a);
    bnf::add<Fq>(e, e, a);
    bnf::sqr<Fq>(f, e);
    bnf::dbl<Fq>(t, d);
    uint32_t xo[8], yo[8], zo[8];
    bnf::sub<Fq>(xo, f, t);
    bnf::dbl<Fq>(c8, c);
    bnf::dbl<Fq>(c8, c8);
    bnf::dbl<Fq>(c8, c8);
    bnf::sub<Fq>(t, d, xo);
    bnf::mul<Fq>(t, e, t);
    bnf::sub<Fq>(yo, t, c8);
    bnf::mul<Fq>(t, y, z);
    bnf::dbl<Fq>(zo, t);
    bnf::canon<Fq>(x3, xo);
    bnf::canon<Fq>(y3, yo);
    bnf::canon<Fq>(z3, zo);
}

// -y mod p, canonical (0 stays 0): the Y of -P (ops/field_torch.neg_mod).
BN_HD void neg(uint32_t r[8], const uint32_t y[8]) {
    uint32_t zero[8];
    bn254::set_zero(zero);
    bnf::sub<Fq>(r, zero, y);
    bnf::canon<Fq>(r, r);
}

// A Jacobian point in memory: word w of coordinate c at p[(8 c + w) stride].
struct PointRef {
    volatile uint32_t* p;
    int64_t stride;
};

BN_HD void get(uint32_t r[8], PointRef a, int c) {
#pragma unroll
    for (int w = 0; w < 8; ++w) r[w] = a.p[(8 * c + w) * a.stride];
}

BN_HD void put(PointRef a, int c, const uint32_t v[8]) {
#pragma unroll
    for (int w = 0; w < 8; ++w) a.p[(8 * c + w) * a.stride] = v[w];
}

// o = P + Q, or P - Q where neg_q (Q's Y negated wherever it is read).
// add-2007-bl with the cases of ops/msm.py::jac_add: P at infinity gives Q,
// else Q at infinity gives P; P = Q (H = 0, R = 0) doubles P; P = -Q (H = 0,
// R != 0) gives infinity with the formula's X and Y, as the formula's own
// Z3 = 2 Z1 Z2 H is 0 there (ops/msm.py zeroes it explicitly). The case is
// known once H and R are, so only the generic case finishes the formula,
// and it stores X3, then Y3, then Z3, each as soon as it is known: o may
// alias P or Q, whose X and Y are read before X3 is stored and whose Z
// before Z3 is.
BN_HD void jac_add(PointRef o, PointRef P, PointRef Q, bool neg_q) {
    uint32_t a[8], b[8], z1z1[8], z2z2[8], u1[8], h[8], s1[8], rr[8];
    get(a, P, 2);
    const bool p_inf = bn254::is_zero(a);
    bnf::sqr<Fq>(z1z1, a);
    get(b, Q, 2);
    const bool q_inf = bn254::is_zero(b);
    bnf::sqr<Fq>(z2z2, b);
    bnf::mul<Fq>(b, b, z2z2);  // Z2^3
    get(a, P, 1);
    bnf::mul<Fq>(s1, a, b);
    get(a, P, 0);
    bnf::mul<Fq>(u1, a, z2z2);
    get(a, Q, 0);
    bnf::mul<Fq>(h, a, z1z1);
    bnf::sub<Fq>(h, h, u1);
    bnf::canon<Fq>(h, h);
    get(a, P, 2);
    bnf::mul<Fq>(z1z1, z1z1, a);  // Z1^3
    get(a, Q, 1);
    if (neg_q) neg(a, a);
    bnf::mul<Fq>(a, a, z1z1);  // S2
    bnf::sub<Fq>(a, a, s1);
    bnf::dbl<Fq>(rr, a);
    bnf::canon<Fq>(rr, rr);

    if (p_inf) {
#pragma unroll 1
        for (int c = 0; c < 3; ++c) {
            get(a, Q, c);
            if (c == 1 && neg_q) neg(a, a);
            put(o, c, a);
        }
        return;
    }
    if (q_inf) {
#pragma unroll 1
        for (int c = 0; c < 3; ++c) {
            get(a, P, c);
            put(o, c, a);
        }
        return;
    }
    if (bn254::is_zero(h) && bn254::is_zero(rr)) {
        uint32_t x1[8], y1[8], z1[8];
        get(x1, P, 0);
        get(y1, P, 1);
        get(z1, P, 2);
        jac_double(x1, y1, z1, x1, y1, z1);
        put(o, 0, x1);
        put(o, 1, y1);
        put(o, 2, z1);
        return;
    }
    bnf::dbl<Fq>(a, h);
    bnf::sqr<Fq>(b, a);  // I = (2H)^2
    bnf::mul<Fq>(z1z1, h, b);  // J
    bnf::mul<Fq>(z2z2, u1, b);  // V
    bnf::sqr<Fq>(a, rr);
    bnf::sub<Fq>(a, a, z1z1);
    bnf::dbl<Fq>(b, z2z2);
    bnf::sub<Fq>(a, a, b);
    bnf::sub<Fq>(b, z2z2, a);
    bnf::canon<Fq>(a, a);  // X3
    put(o, 0, a);
    bnf::mul<Fq>(b, rr, b);
    bnf::mul<Fq>(a, s1, z1z1);
    bnf::dbl<Fq>(a, a);
    bnf::sub<Fq>(b, b, a);
    bnf::canon<Fq>(b, b);  // Y3
    put(o, 1, b);
    get(a, P, 2);
    get(b, Q, 2);
    bnf::mul<Fq>(a, a, b);
    bnf::mul<Fq>(a, a, h);
    bnf::dbl<Fq>(a, a);
    bnf::canon<Fq>(a, a);  // Z3 = 2 Z1 Z2 H
    put(o, 2, a);
}

// The same on three register points (the outputs may alias the inputs).
BN_HD void jac_add(uint32_t x3[8], uint32_t y3[8], uint32_t z3[8],
                   const uint32_t x1[8], const uint32_t y1[8], const uint32_t z1[8],
                   const uint32_t x2[8], const uint32_t y2[8], const uint32_t z2[8]) {
    uint32_t buf[72];
    const PointRef P{buf, 1}, Q{buf + 24, 1}, O{buf + 48, 1};
    put(P, 0, x1);
    put(P, 1, y1);
    put(P, 2, z1);
    put(Q, 0, x2);
    put(Q, 1, y2);
    put(Q, 2, z2);
    jac_add(O, P, Q, false);
    get(x3, O, 0);
    get(y3, O, 1);
    get(z3, O, 2);
}

// Index of the highest set bit of v != 0.
BN_HD int top_bit(uint32_t v) {
#ifdef __CUDA_ARCH__
    return 31 - __clz((int)v);
#else
    return 31 - __builtin_clz(v);
#endif
}

// Word i of k (i < 8) by selects, so that k stays in registers.
BN_HD uint32_t word(const uint32_t k[8], int i) {
    uint32_t r = k[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) r = i == j ? k[j] : r;
    return r;
}

// (x, y, z) = k P for a plain (not Montgomery) scalar k of 8 words, LSB
// first as utils/ec_fft.py::_scalar_mul_vec of the JAX package: R starts at
// infinity (all words 0), A at P; for each bit i, R = R + A where bit i is
// set, then A = 2 A. The doublings stop after k's top bit, where R no
// longer changes. k = 0 gives (0, 0, 0).
BN_HD void scalar_mul(uint32_t x[8], uint32_t y[8], uint32_t z[8], const uint32_t px[8],
                      const uint32_t py[8], const uint32_t pz[8], const uint32_t k[8]) {
    uint32_t ax[8], ay[8], az[8];
    bn254::copy(ax, px);
    bn254::copy(ay, py);
    bn254::copy(az, pz);
    bn254::set_zero(x);
    bn254::set_zero(y);
    bn254::set_zero(z);
    int top = -1;
#pragma unroll
    for (int i = 0; i < 8; ++i)
        if (k[i]) top = 32 * i + top_bit(k[i]);
    for (int i = 0; i <= top; ++i) {
        if ((word(k, i >> 5) >> (i & 31)) & 1u) jac_add(x, y, z, x, y, z, ax, ay, az);
        if (i < top) jac_double(ax, ay, az, ax, ay, az);
    }
}

}  // namespace g1
