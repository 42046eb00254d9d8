// Threefry-2x32 counter draws for Hopper (sm_90a), bit for bit
// jax.random's.
//
// Port-only: it replaces no TPU kernel.  The JAX package draws its
// surrogate phases and its ICA block shifts from jax.random keys, whose
// threefry bits are the same on every backend; the port draws the same
// bits (ops/prng.py is the plain version, ops/cuda_prng.py the wrapper).
// For one key and the flat counters i = 0..n-1 (the row-major index of
// a draw's element, as (hi, lo) = (i >> 32, i & 0xffffffff) under
// jax_threefry_partitionable), each thread runs the 20 rounds in
// registers and writes, by mode:
//   0  both words (y0, y1): jax.random.split's keys;
//   1  y0 ^ y1: jax.random.bits;
//   2  jax.random.uniform: the top 23 bits of y0 ^ y1 as the mantissa
//      of a float in [1, 2), minus 1, then fma(f, span, minval) (XLA
//      fuses the scale and shift into one rounding), floored at minval.
// mba_threefry_keys draws mode 2 for many keys in one launch, n_per
// counters under each.
//
// What bounds it on the H100: on paper the bytes written.  The null's
// phase draw, (12, 500, 5, 175) float32, is 5.25 M draws and 21 MB, 6.3
// us at 3.35 TB/s; its ~77 integer operations a draw (3 per round, the
// key injections, the conversion) are 0.40 G operations, as long at the
// float32 rate, but the INT32 pipe issues at half that rate, and the
// kernel reaches about a quarter of the byte bound (PERF.md): the rounds'
// issue rate bounds it.  The rotations are funnel shifts, one
// instruction each.  One thread per counter in a grid-stride loop,
// coalesced 4-byte (8-byte for pairs) stores, nothing read.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 65535;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define MBA_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl(x1, r);     \
  x1 ^= x0;
#define MBA_TF_GROUP(a, b, c, d) \
  MBA_TF_ROUND(a) MBA_TF_ROUND(b) MBA_TF_ROUND(c) MBA_TF_ROUND(d)
  x0 += k0;
  x1 += k1;
  MBA_TF_GROUP(13, 15, 26, 6)
  x0 += k1;
  x1 += k2 + 1u;
  MBA_TF_GROUP(17, 29, 16, 24)
  x0 += k2;
  x1 += k0 + 2u;
  MBA_TF_GROUP(13, 15, 26, 6)
  x0 += k0;
  x1 += k1 + 3u;
  MBA_TF_GROUP(17, 29, 16, 24)
  x0 += k1;
  x1 += k2 + 4u;
  MBA_TF_GROUP(13, 15, 26, 6)
  x0 += k2;
  x1 += k0 + 5u;
#undef MBA_TF_GROUP
#undef MBA_TF_ROUND
}

__device__ __forceinline__ float to_uniform(uint32_t bits, float minval,
                                            float span) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(minval, __fmaf_rn(f, span, minval));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
threefry_kernel(uint32_t k0, uint32_t k1, void* __restrict__ out,
                long long n, float minval, float span) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t x0 = (uint32_t)((unsigned long long)i >> 32);
    uint32_t x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    if (MODE == 0) {
      reinterpret_cast<uint2*>(out)[i] = make_uint2(x0, x1);
    } else if (MODE == 1) {
      reinterpret_cast<uint32_t*>(out)[i] = x0 ^ x1;
    } else {
      reinterpret_cast<float*>(out)[i] = to_uniform(x0 ^ x1, minval, span);
    }
  }
}

// One uniform draw of n_per values per key: row s of out is
// jax.random.uniform(keys[s], (n_per,)), counters 0..n_per-1 under each
// key (the full-FFT null's one draw per surrogate, in one launch).
__global__ void __launch_bounds__(THREADS)
threefry_keys_kernel(const uint32_t* __restrict__ keys,
                     float* __restrict__ out, long long n_keys,
                     long long n_per, float minval, float span) {
  const long long n = n_keys * n_per;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const long long s = i / n_per;
    const long long j = i - s * n_per;
    uint32_t x0 = (uint32_t)((unsigned long long)j >> 32);
    uint32_t x1 = (uint32_t)j;
    threefry2x32(keys[2 * s], keys[2 * s + 1], x0, x1);
    out[i] = to_uniform(x0 ^ x1, minval, span);
  }
}

long long grid_blocks(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks;
}

}  // namespace

// out: n uint2 (mode 0), n uint32 (mode 1) or n float32 (mode 2),
// 8-byte aligned for mode 0.  Returns a cudaError_t.
extern "C" int mba_threefry(unsigned int k0, unsigned int k1, void* out,
                            long long n, int mode, float minval, float span,
                            void* stream) {
  if (n < 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (mode == 0 && reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)grid_blocks(n));
  if (mode == 0)
    threefry_kernel<0><<<grid, THREADS, 0, s>>>(k0, k1, out, n, minval, span);
  else if (mode == 1)
    threefry_kernel<1><<<grid, THREADS, 0, s>>>(k0, k1, out, n, minval, span);
  else
    threefry_kernel<2><<<grid, THREADS, 0, s>>>(k0, k1, out, n, minval, span);
  return (int)cudaGetLastError();
}

// keys: n_keys (k0, k1) uint32 pairs on the card; out: n_keys × n_per
// float32.  Returns a cudaError_t.
extern "C" int mba_threefry_keys(const void* keys, void* out,
                                 long long n_keys, long long n_per,
                                 float minval, float span, void* stream) {
  if (n_keys < 0 || n_per < 0) return (int)cudaErrorInvalidValue;
  if (n_keys == 0 || n_per == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)grid_blocks(n_keys * n_per));
  threefry_keys_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(
      stream)>>>(static_cast<const uint32_t*>(keys),
                 static_cast<float*>(out), n_keys, n_per, minval, span);
  return (int)cudaGetLastError();
}
