// BN254 Fr / Fq Montgomery arithmetic for one CUDA thread.
//
// An element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256 (the same domain as the port's 16x16-bit torch limbs and the
// JAX package's field_jax; not the TPU kernels' R = 2^255). Multiplication
// is word-serial CIOS: each 32x32 product is one mul.wide.u32, and the
// 64-bit accumulator (t + a*b + carry < 2^64) never overflows. Every
// function returns canonical values (< p), so results are bit-identical to
// the plain torch version of the same formula.
//
// The header also compiles as plain C++ (BN_HD expands to `static inline`),
// which lets the per-thread arithmetic be unit-tested with g++ on a host.

#pragma once
#include <cstdint>

#ifdef __CUDACC__
#define BN_HD static __host__ __device__ __forceinline__
#else
#define BN_HD static inline
#endif

namespace bn254 {

struct Fr {
    BN_HD uint32_t mod(int i) {
        const uint32_t m[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
        return m[i];
    }
    BN_HD uint32_t one(int i) {
        const uint32_t m[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                               0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
        return m[i];
    }
    static constexpr uint32_t INV = 0xefffffffu;  // -p^{-1} mod 2^32
};

struct Fq {
    BN_HD uint32_t mod(int i) {
        const uint32_t m[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
        return m[i];
    }
    BN_HD uint32_t one(int i) {
        const uint32_t m[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                               0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
        return m[i];
    }
    static constexpr uint32_t INV = 0xe4866389u;
};

BN_HD void copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = a[i];
}

BN_HD void set_zero(uint32_t r[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = 0;
}

BN_HD bool is_zero(const uint32_t a[8]) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc |= a[i];
    return acc == 0;
}

// r = t - p if t >= p else t, for t < 2p given as 8 words plus a top word.
template <class P>
BN_HD void reduce_once(uint32_t r[8], const uint32_t t[8], uint32_t top) {
    uint32_t d[8];
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int64_t s = (int64_t)t[i] - (int64_t)P::mod(i) + borrow;
        d[i] = (uint32_t)s;
        borrow = s >> 32;  // 0 or -1
    }
    bool ge = (int64_t)top + borrow >= 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = ge ? d[i] : t[i];
}

template <class P>
BN_HD void add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t s[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (uint64_t)a[i] + b[i];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    reduce_once<P>(r, s, (uint32_t)c);
}

template <class P>
BN_HD void sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t d[8];
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int64_t s = (int64_t)a[i] - (int64_t)b[i] + borrow;
        d[i] = (uint32_t)s;
        borrow = s >> 32;
    }
    if (borrow) {  // a < b: add p back
        uint64_t c = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            c += (uint64_t)d[i] + P::mod(i);
            d[i] = (uint32_t)c;
            c >>= 32;
        }
    }
    copy(r, d);
}

template <class P>
BN_HD void dbl(uint32_t r[8], const uint32_t a[8]) {
    add<P>(r, a, a);
}

// CIOS Montgomery product r = a*b*2^-256 mod p (r may alias a or b).
template <class P>
BN_HD void mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint64_t s = (uint64_t)t[j] + (uint64_t)a[j] * b[i] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[8] + c;
        t[8] = (uint32_t)s;
        t[9] = (uint32_t)(s >> 32);
        uint32_t m = t[0] * P::INV;
        s = (uint64_t)t[0] + (uint64_t)m * P::mod(0);
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            s = (uint64_t)t[j] + (uint64_t)m * P::mod(j) + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[8] + c;
        t[7] = (uint32_t)s;
        t[8] = t[9] + (uint32_t)(s >> 32);
    }
    reduce_once<P>(r, t, t[8]);
}

}  // namespace bn254
