// Kernel B3: rotation-null coefficient pair pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mba_tpu/ops/pallas_coeffs.py:_coeff_tile_kernel (:83-122).  Input: the K
// tapered band spectra of one chunk of windows, eeg (wc, K, F, E) and
// emg (wc, K, F, M), complex64 (float2, re/im interleaved), and the window
// weights w (wc,).  Per window and cell (f, e, m) it forms the
// power-normalised taper products
//     y_k = conj(E_k)·M_k · sqrt(w / max(pe·pm, FLT_MIN)),
//     pe = Σ_k |E_k|²,  pm = Σ_k |M_k|²,
// and sums over the chunk's windows the taper diagonal Σ_k |y_k|² and, for
// each of the P2 = K(K−1)/2 pairs k < l, Re and Im of y_k·conj(y_l):
// diag (F, N), pr and pi (P2, F, N), N = E·M, frequency-major.  The
// (wc, K, F, N) products never reach device memory.
//
// What bounds it on the H100: float32 arithmetic on the CUDA cores.  Each
// (window, cell) costs ~150 flops (K cross products and scalings, one
// IEEE division and square root, K diagonal and P2 complex pair terms)
// against 8·K bytes of spectra per (window, f, channel) that every pair of
// the block reuses.  At the main path's chunk (wc=32, K=5, F=175, 64×64)
// that is 3.4 GFLOP per chunk and ~60 MB of sums per subject.  (The plain
// version writes the y_k, 2 × 459 MB per chunk, and reads them back for
// each of the 10 pairs: ~9 GB a chunk, bound by memory.)  The design: the
// TPU kernel's window grid axis, fastest and accumulated in a resident
// output block, becomes a loop inside the block.  One block per
// (frequency, EB EEG × MB EMG channel tile), EB·MB = 256 threads, one
// thread per cell; its 1 + 2·P2 sums (21 at K=5, 57 at K=8) stay in
// registers for the whole chunk and are stored once: no atomics, no
// read-modify-write of device memory, deterministic.  Per window the block
// stages its EB EEG and MB EMG spectra and their powers pe/pm in shared
// memory; a warp shares one e when MB >= 32, so the EEG reads are
// broadcasts and the EMG reads consecutive.  Faster forms (several
// windows per barrier, cells per thread) are later work.
//
// Numerics: no fast math.  The clamp is NaN-propagating, as jnp.maximum:
// a NaN spectrum gives NaN sums even in a zero-weight window, which is
// evaluated like any other.  IEEE division and sqrtf; denormals are kept
// (no -ftz), so a denormal pe·pm clamps to FLT_MIN as on the CPU.  nvcc
// may contract the products into FMAs, which the plain version does not:
// agreement is to float32 rounding, stated with the wrapper.

#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;   // cells per block: EB × MB
constexpr int MB_MAX = 64;     // EMG channels per block at most

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
coeff_pairs_kernel(const float2* __restrict__ eeg,
                   const float2* __restrict__ emg,
                   const float* __restrict__ weights,
                   float* __restrict__ diag, float* __restrict__ pr,
                   float* __restrict__ pi, int wc, int F, int E, int M,
                   int EB, int MB) {
  constexpr int P2 = K * (K - 1) / 2;
  __shared__ float2 es[K][THREADS];    // [k][e_local]
  __shared__ float2 ms[K][MB_MAX];     // [k][m_local]
  __shared__ float pes[THREADS];
  __shared__ float pms[MB_MAX];

  const int f = blockIdx.x;
  const int e0 = blockIdx.y * EB, m0 = blockIdx.z * MB;
  const int t = threadIdx.x;
  const int el = t / MB, ml = t - el * MB;
  const int e = e0 + el, m = m0 + ml;
  const bool active = e < E && m < M;

  float d = 0.f;
  float ar[P2], ai[P2];
#pragma unroll
  for (int p = 0; p < P2; ++p) ar[p] = ai[p] = 0.f;

  for (int win = 0; win < wc; ++win) {
    // stage the block's EB EEG and MB EMG spectra of this window
    for (int i = t; i < EB + MB; i += THREADS) {
      const bool is_e = i < EB;
      const int c = is_e ? e0 + i : m0 + (i - EB);
      const int C = is_e ? E : M;
      const float2* src = is_e ? eeg : emg;
      float pw = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 v = (c < C)
            ? src[(((size_t)win * K + k) * F + f) * C + c]
            : make_float2(0.f, 0.f);
        pw += v.x * v.x + v.y * v.y;
        if (is_e) es[k][i] = v; else ms[k][i - EB] = v;
      }
      if (is_e) pes[i] = pw; else pms[i - EB] = pw;
    }
    __syncthreads();
    if (active) {
      const float den = nan_max(pes[el] * pms[ml], FLT_MIN);
      const float sc = sqrtf(weights[win] / den);
      float yr[K], yi[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 a = es[k][el], b = ms[k][ml];
        // conj(E)·M: re = er·mr + ei·mi, im = er·mi − ei·mr
        yr[k] = (a.x * b.x + a.y * b.y) * sc;
        yi[k] = (a.x * b.y - a.y * b.x) * sc;
        d += yr[k] * yr[k] + yi[k] * yi[k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int l = k + 1; l < K; ++l) {
          const int p = k * (2 * K - k - 1) / 2 + (l - k - 1);  // triu order
          ar[p] += yr[k] * yr[l] + yi[k] * yi[l];
          ai[p] += yi[k] * yr[l] - yr[k] * yi[l];
        }
    }
    __syncthreads();
  }

  if (active) {
    const size_t N = (size_t)E * M;
    const size_t o = (size_t)f * N + (size_t)e * M + m;
    diag[o] = d;
#pragma unroll
    for (int p = 0; p < P2; ++p) {
      pr[p * F * N + o] = ar[p];
      pi[p * F * N + o] = ai[p];
    }
  }
}

template <int K>
cudaError_t launch(const void* eeg, const void* emg, const void* weights,
                   void* diag, void* pr, void* pi, int wc, int F, int E,
                   int M, cudaStream_t stream) {
  int MB = 1;
  while (MB < M && MB < MB_MAX) MB *= 2;
  const int EB = THREADS / MB;
  const dim3 grid(F, (E + EB - 1) / EB, (M + MB - 1) / MB);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  coeff_pairs_kernel<K><<<grid, THREADS, 0, stream>>>(
      static_cast<const float2*>(eeg), static_cast<const float2*>(emg),
      static_cast<const float*>(weights), static_cast<float*>(diag),
      static_cast<float*>(pr), static_cast<float*>(pi), wc, F, E, M, EB, MB);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mba_coeff_pairs(const void* eeg, const void* emg,
                               const void* weights, void* diag, void* pr,
                               void* pi, int wc, int K, int F, int E, int M,
                               void* stream) {
  if (wc < 0 || F <= 0 || E <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: return launch<2>(eeg, emg, weights, diag, pr, pi, wc, F, E, M, s);
    case 3: return launch<3>(eeg, emg, weights, diag, pr, pi, wc, F, E, M, s);
    case 4: return launch<4>(eeg, emg, weights, diag, pr, pi, wc, F, E, M, s);
    case 5: return launch<5>(eeg, emg, weights, diag, pr, pi, wc, F, E, M, s);
    case 6: return launch<6>(eeg, emg, weights, diag, pr, pi, wc, F, E, M, s);
    case 7: return launch<7>(eeg, emg, weights, diag, pr, pi, wc, F, E, M, s);
    case 8: return launch<8>(eeg, emg, weights, diag, pr, pi, wc, F, E, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
