// X0 and X1: the prover's field arithmetic and NTT stage on the card, one
// thread an element (a butterfly for X1), reading and writing the port's
// (16, *batch) int64 16-bit limb tensors in place of any conversion pass.
//
// Replaces the JAX package's compiled (XLA, not Pallas) field arithmetic and
// transform, which its prover runs as jitted programs:
// - X0a field_mont_mul_cuda: circuits_halo2_tpu/ops/field_jax.py::mont_mul
//   (and mont_sqr, to_mont, from_mont, pow5, which call it);
// - X0b field_linear_cuda: field_jax.py::add_mod, sub_mod, neg_mod, one
//   kernel with an op code;
// - X0c field_pow_cuda: field_jax.py::mont_pow (a lax.scan over the
//   exponent's bits) and inv_mont, the Fermat inversion of
//   utils/poly_device.py::batch_inv_dev;
// - X1 ntt_stages_cuda: ops/ntt.py::_ntt_core_scan, the jitted scan over the
//   radix-2 stages of _ntt_device, one launch a stage.
// The plain torch versions are ops/field_torch.py's *_ref functions and
// ops/ntt.py::ntt_ref; the per-thread code (csrc/field_ops.cuh) gives their
// limbs exactly.
//
// What bounds them on the card. A product is 132 wide multiplies (64 word
// products, 68 in the reduction) against 384 bytes of int64 limbs (two
// operands in, one out; a broadcast operand is read once): at the H100's
// 3.35 TB/s and about 8.4e12 wide multiplies a second, 115 ns of bytes for
// 16 ns of multiplies a thousand elements, so X0a, X0b and X1 are bound by
// the bytes of the int64-limb layout (four times those of 32-byte elements).
// X0c is operations: about 380 products an element for an inversion, and
// on the prover's path only a few elements (one a permutation set or
// lookup), so a launch is one thread's dependent chain of 380 products.
//
// Design: the simplest kernels that are right. Each thread computes its
// operands' offsets from its batch index through the strides the wrapper
// hands over (collapsed here on the host where axes are contiguous in every
// operand, so most calls decompose over one or two axes), loads 16 limbs an
// operand with the carries between them propagated, runs the per-thread
// code and stores 16 normalised limbs; consecutive threads touch
// consecutive int64s of every limb row. The NTT runs its stages in place on
// the bit-reversed copy the wrapper makes, one thread a butterfly.

#include "field_ops.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

using bn254::Fq;
using bn254::Fr;

namespace {

constexpr int THREADS = 256;      // X0a, X0b, X1
constexpr int POW_THREADS = 128;  // X0c

unsigned blocks(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <class P>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, fops::Shape s, fops::Strides sa, fops::Strides sb,
                uint32_t n) {
    const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) fops::mont_mul_thread<P>(a, b, out, s, sa, sb, n, t);
}

template <class P>
__global__ void __launch_bounds__(THREADS)
linear_kernel(int op, const int64_t* __restrict__ a, const int64_t* __restrict__ b,
              int64_t* __restrict__ out, fops::Shape s, fops::Strides sa, fops::Strides sb,
              uint32_t n) {
    const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) fops::linear_thread<P>(op, a, b, out, s, sa, sb, n, t);
}

template <class P>
__global__ void __launch_bounds__(POW_THREADS)
pow_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out, fops::Shape s,
           fops::Strides sa, fops::Exponent e, uint32_t n) {
    const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) fops::pow_thread<P>(a, out, s, sa, e, n, t);
}

__global__ void __launch_bounds__(THREADS)
ntt_stage_kernel(int64_t* __restrict__ x, const int64_t* __restrict__ tw, uint32_t rows,
                 int logn, int s) {
    const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g < (rows << (logn - 1))) fops::ntt_thread(x, tw, rows, logn, s, g);
}

}  // namespace

// field: 0 Fr, 1 Fq. out is a contiguous (16, n) tensor, n the batch size.
extern "C" int field_mont_mul_cuda(const int64_t* a, const int64_t* b, int64_t* out,
                                   const int64_t* meta, int nd, int field, void* stream) {
    fops::Shape s;
    fops::Strides sa, sb;
    int64_t n;
    if (!fops::collapse(meta, nd, s, sa, sb, n) || field < 0 || field > 1)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const uint32_t m = (uint32_t)n;
    const auto st = (cudaStream_t)stream;
    if (field == 0)
        mont_mul_kernel<Fr><<<blocks(m, THREADS), THREADS, 0, st>>>(a, b, out, s, sa, sb, m);
    else
        mont_mul_kernel<Fq><<<blocks(m, THREADS), THREADS, 0, st>>>(a, b, out, s, sa, sb, m);
    return (int)cudaGetLastError();
}

// op: 0 a + b, 1 a - b, 2 -a (b unused; its strides are a's)
extern "C" int field_linear_cuda(int op, const int64_t* a, const int64_t* b, int64_t* out,
                                 const int64_t* meta, int nd, int field, void* stream) {
    fops::Shape s;
    fops::Strides sa, sb;
    int64_t n;
    if (!fops::collapse(meta, nd, s, sa, sb, n) || field < 0 || field > 1 || op < 0 || op > 2)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const uint32_t m = (uint32_t)n;
    const auto st = (cudaStream_t)stream;
    if (field == 0)
        linear_kernel<Fr><<<blocks(m, THREADS), THREADS, 0, st>>>(op, a, b, out, s, sa, sb, m);
    else
        linear_kernel<Fq><<<blocks(m, THREADS), THREADS, 0, st>>>(op, a, b, out, s, sa, sb, m);
    return (int)cudaGetLastError();
}

// exp: the exponent's 8 little-endian words, nbits its bits from the top
// one (1 for the exponent 0); meta as above, a given twice.
extern "C" int field_pow_cuda(const int64_t* a, int64_t* out, const int64_t* meta, int nd,
                              const uint32_t* exp, int nbits, int field, void* stream) {
    fops::Shape s;
    fops::Strides sa, unused;
    int64_t n;
    if (!fops::collapse(meta, nd, s, sa, unused, n) || field < 0 || field > 1 || nbits < 1
        || nbits > 256)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const uint32_t m = (uint32_t)n;
    fops::Exponent e;
    for (int i = 0; i < 8; ++i) e.w[i] = exp[i];
    e.nbits = nbits;
    const auto st = (cudaStream_t)stream;
    if (field == 0)
        pow_kernel<Fr><<<blocks(m, POW_THREADS), POW_THREADS, 0, st>>>(a, out, s, sa, e, m);
    else
        pow_kernel<Fq><<<blocks(m, POW_THREADS), POW_THREADS, 0, st>>>(a, out, s, sa, e, m);
    return (int)cudaGetLastError();
}

// Every stage of `rows` bit-reversed n = 2^logn point rows, in place on the
// contiguous (16, rows, n) x, one launch a stage; tw (16, n - 1) contiguous.
extern "C" int ntt_stages_cuda(int64_t* x, const int64_t* tw, int64_t rows, int logn,
                               void* stream) {
    if (logn < 1 || logn > 30 || rows < 1 || (rows << logn) >= ((int64_t)1 << 32))
        return (int)cudaErrorInvalidValue;
    const int64_t threads = rows << (logn - 1);
    for (int s = 0; s < logn; ++s) {
        ntt_stage_kernel<<<blocks(threads, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
            x, tw, (uint32_t)rows, logn, s);
        const int err = (int)cudaGetLastError();
        if (err) return err;
    }
    return 0;
}
#endif
