// Kernel B2: rotation-null surrogate tile for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel mba_tpu/ops/pallas_null.py:_null_tile_kernel
// (:37-76) at compute_dtype float32 (the 16-bit instances run on the
// tensor cores: csrc/null_tile_tc.cu).  Per frequency f it evaluates the
// surrogate statistic
//     stat[s, n] = base[f, n] + (Gᵀ[f] · coefT[f])[s, n] / J
// with G (nF, JP, S) the phase features of S surrogates, stored k-major,
// and coefT (nF, JP, N) the rotation coefficients (J·P flattened), and
// reduces it in the epilogue: per cell n the count of surrogates with
// stat >= obs[f, n], and per surrogate s the max over all (f, n).  The
// (F, S, N) statistic never reaches device memory.
//
// What bounds it on the H100: float32 arithmetic on the CUDA cores.  The
// main path's chunk (nF=175, S=500, J·P=240, N=4096) is 2·175·500·240·4096
// = 1.720e11 flop against 0.78 GB read once: 2.57 ms at 67 TFLOP/s
// against 0.23 ms at 3.35 TB/s.  The first form (64×64 tiles, 4×4
// micro-tiles, synchronous 16-deep slices reloaded for every surrogate
// tile) ran at 36 % of that bound.  Tensor cores would change the
// numerics (TF32, bf16) and are out of this kernel until a parity
// decision.
//
// The design, an SGEMM staged for Hopper's CUDA cores:
// * One block per (128-cell tile, 128-surrogate tile, frequency): 22 400
//   blocks on the main path, so the last, partial wave is a small share
//   of the run.  256 threads each hold an 8×8 micro-tile of the 128×128
//   block tile, rows {4ty..4ty+3, 64+4ty..} and columns {4tx..4tx+3,
//   64+4tx..}: per k step four 16-byte shared loads feed 64 FMAs, and
//   the eight lanes of a quarter-warp read 128 contiguous bytes of B (no
//   bank conflict) while A is a broadcast.
// * Both operands are k-major ([k][s] and [k][n]), so a 16-deep slice of
//   each is copied global → shared by cp.async with no transpose: 16-byte
//   copies where rows are 16-byte aligned (S and N multiples of 4, as on
//   the main path), 4-byte copies otherwise, zero-filled past S, N and
//   J·P.  A ring of four slices keeps three copies in flight while one
//   is computed.  (The k-major G is the layout cuda_null.null_features
//   produces.)
// * Epilogue: the statistic rounded as the plain version rounds it,
//   base + (product · 1/J), so that with cuBLAS's k-ordered sums the two
//   agree to the bit (an FMA here is a little faster and moves a count in
//   ~5e-6 of the cells); counts over real rows only (the padded-row rule
//   of pallas_null.py:58-62), summed per column in shared memory and
//   added to the cell's count by one integer atomic a block (exact in any
//   order); each row's max over the block's real cells, NaN-propagating,
//   written as one partial per (frequency, cell tile, surrogate), which
//   the second kernel reduces per surrogate (mba_null_reduce_max, which
//   the tensor-core instances share): no float atomics, so the max is
//   deterministic.
// * 64 KB of ring a block and __launch_bounds__(256, 2) (≤ 128
//   registers): two blocks, 16 warps, an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // surrogates per tile
constexpr int BN = 128;         // cells per block
constexpr int BK = 16;          // J·P slice depth
constexpr int STAGES = 4;       // slices in the ring
constexpr int THREADS = 256;    // 16 × 16 threads, 8 × 8 outputs each
constexpr int RED_X = 32;       // surrogates per reduction block
constexpr int RED_Y = 8;        // partial rows per reduction step

constexpr int SLICE = BK * BM;  // elements of one operand slice (BM == BN)
constexpr size_t SMEM_BYTES = (size_t)STAGES * 2 * SLICE * sizeof(float)
    + 2 * BN * sizeof(float) + BN * sizeof(int);      // base, obs, counts

// four consecutive floats (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.max semantics: a NaN anywhere gives NaN
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows k0..k0+BK of a k-major (JP, ld) operand, columns
// c0..c0+128, into a [BK][128] slice; zero past JP and ld.  VEC: 16-byte
// cp.async copies (ld a multiple of 4); else 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int JP, int ld, int k0, int c0,
                                           int t) {
  if constexpr (VEC) {
#pragma unroll
    for (int r = 0; r < SLICE / 4 / THREADS; ++r) {
      const int q = t + r * THREADS;                  // 16-byte chunk
      const int k = q / (BM / 4), c = (q % (BM / 4)) * 4;
      const bool ok = k0 + k < JP && c0 + c < ld;     // ld % 4 == 0
      cp_async16(dst + k * BM + c,
                 ok ? src + (size_t)(k0 + k) * ld + c0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int r = 0; r < SLICE / THREADS; ++r) {
      const int q = t + r * THREADS;
      const int k = q / BM, c = q % BM;
      const bool ok = k0 + k < JP && c0 + c < ld;
      cp_async4(dst + k * BM + c,
                ok ? src + (size_t)(k0 + k) * ld + c0 + c : src, ok ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
null_tile_kernel(const float* __restrict__ G,
                 const float* __restrict__ coefT,
                 const float* __restrict__ base,
                 const float* __restrict__ obs,
                 float* __restrict__ partial_max, int* __restrict__ counts,
                 int S, int ldg, int JP, int N, float inv_J) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);        // [STAGES][BK][BM]
  float* Bs = As + STAGES * SLICE;                    // [STAGES][BK][BN]
  float* base_s = Bs + STAGES * SLICE;                // [BN]
  float* obs_s = base_s + BN;                         // [BN]
  int* cnt_s = reinterpret_cast<int*>(obs_s + BN);    // [BN]

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int tn = blockIdx.x;
  const int s0 = blockIdx.y * BM;
  const int f = blockIdx.z;
  const int n0 = tn * BN;
  const float* Gf = G + (size_t)f * JP * ldg;
  const float* Cf = coefT + (size_t)f * JP * N;

  if (t < BN) {
    const int n = n0 + t;
    base_s[t] = n < N ? base[(size_t)f * N + n] : 0.f;
    obs_s[t] = n < N ? obs[(size_t)f * N + n] : 0.f;
    cnt_s[t] = 0;
  }

  const int steps = (JP + BK - 1) / BK;              // J·P slices
  auto stage_step = [&](int step) {
    const int stage = step % STAGES;
    load_slice<VEC>(As + stage * SLICE, Gf, JP, ldg, step * BK, s0, t);
    load_slice<VEC>(Bs + stage * SLICE, Cf, JP, N, step * BK, n0, t);
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < steps) stage_step(p);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();        // this step's slice has landed
    __syncthreads();                    // ... for every thread, and the
                                        // slot refilled below is free
    if (step + STAGES - 1 < steps) stage_step(step + STAGES - 1);
    cp_async_commit();

    const float* a = As + (step % STAGES) * SLICE;
    const float* b = Bs + (step % STAGES) * SLICE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[8], bv[8];
      load4(a + k * BM + ty * 4, av);
      load4(a + k * BM + 64 + ty * 4, av + 4);
      load4(b + k * BN + tx * 4, bv);
      load4(b + k * BN + 64 + tx * 4, bv + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
  }

  // epilogue: counts over real rows, row max over real cells
  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = s0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    const bool row_ok = s < S;
    float row_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
      // the plain version's base + (G·coefT)·(1/J), each step rounded:
      // with cuBLAS's k-ordered sums the statistic is the same float
      const float stat = __fadd_rn(base_s[c], __fmul_rn(acc[i][j], inv_J));
      if (n0 + c < N) {
        row_max = nan_max(row_max, stat);
        if (row_ok && stat >= obs_s[c]) ++cnt[j];
      }
    }
    // max over the 16 threads (tx) that share this row: the lanes of one
    // half-warp, which together hold all 128 cells
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      row_max = nan_max(row_max,
                        __shfl_xor_sync(0xffffffffu, row_max, off, 16));
    if (tx == 0 && row_ok)
      partial_max[((size_t)f * gridDim.x + tn) * S + s] = row_max;
  }
  // the two half-warps hold the same columns: add them, then one shared
  // atomic a column per warp, then one device atomic a column per block
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cnt[j] += __shfl_xor_sync(0xffffffffu, cnt[j], 16);
    if ((t & 16) == 0 && cnt[j] != 0)
      atomicAdd(&cnt_s[j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4], cnt[j]);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (t < BN && n0 + t < N && cnt_s[t] != 0)
    atomicAdd(&counts[(size_t)f * N + n0 + t], cnt_s[t]);
}

// max over the nT partial rows of each surrogate: partial is (nT, S)
__global__ void reduce_max_kernel(const float* __restrict__ partial,
                                  float* __restrict__ max_out, int nT,
                                  int S) {
  __shared__ float red[RED_Y][RED_X];
  const int s = blockIdx.x * RED_X + threadIdx.x;
  float m = -INFINITY;
  if (s < S)
    for (int r = threadIdx.y; r < nT; r += RED_Y)
      m = nan_max(m, partial[(size_t)r * S + s]);
  red[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && s < S) {
    for (int r = 1; r < RED_Y; ++r) m = nan_max(m, red[r][threadIdx.x]);
    max_out[s] = m;
  }
}

template <bool VEC>
cudaError_t launch_tile(const float* G, const float* coefT, const float* base,
                        const float* obs, float* partial_max, int* counts,
                        int nF, int S, int ldg, int JP, int N, float inv_J,
                        cudaStream_t s) {
  auto kernel = null_tile_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // the blocks of a cell tile add their counts
  err = cudaMemsetAsync(counts, 0, (size_t)nF * N * sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + BN - 1) / BN, (S + BM - 1) / BM, nF), THREADS,
           SMEM_BYTES, s>>>(G, coefT, base, obs, partial_max, counts, S, ldg,
                            JP, N, inv_J);
  return cudaGetLastError();
}

}  // namespace

// max over the nT partial rows (nT, S) of each surrogate → max_out (S,)
extern "C" int mba_null_reduce_max(const void* partial, void* max_out,
                                   int nT, int S, void* stream) {
  reduce_max_kernel<<<(S + RED_X - 1) / RED_X, dim3(RED_X, RED_Y), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(max_out), nT,
      S);
  return (int)cudaGetLastError();
}

// float32 G (nF, JP, ldg) and coefT (nF, JP, N); S <= ldg real surrogates
extern "C" int mba_null_tile(const void* G, const void* coefT,
                             const void* base, const void* obs,
                             void* partial_max, void* counts, void* max_out,
                             int nF, int S, int ldg, int JP, int N,
                             float inv_J, void* stream) {
  if (nF <= 0 || nF > 65535 || S <= 0 || S > ldg ||
      (S + BM - 1) / BM > 65535 || JP <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(G);
  const float* c = static_cast<const float*>(coefT);
  // 16-byte copies: rows of a whole number of 16 bytes, 16-byte aligned
  const bool vec = ldg % 4 == 0 && N % 4 == 0
      && reinterpret_cast<uintptr_t>(G) % 16 == 0
      && reinterpret_cast<uintptr_t>(coefT) % 16 == 0;
  cudaError_t err = (vec ? launch_tile<true> : launch_tile<false>)(
      g, c, static_cast<const float*>(base), static_cast<const float*>(obs),
      static_cast<float*>(partial_max), static_cast<int*>(counts), nF, S, ldg,
      JP, N, inv_J, s);
  if (err != cudaSuccess) return (int)err;
  return mba_null_reduce_max(partial_max, max_out, nF * ((N + BN - 1) / BN),
                             S, stream);
}
