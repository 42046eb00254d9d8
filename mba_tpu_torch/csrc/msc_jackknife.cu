// Kernel B1: fused jackknife-MSC epilogue for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mba_tpu/ops/pallas_msc.py:_msc_block_kernel
// (:40-123).  Input: the K tapered rFFT spectra of a chunk of windows,
// eeg (W, K, F, E) and emg (W, K, F, M), complex64 (float2, re/im
// interleaved).  Per (window, frequency, EEG e, EMG m) cell it forms the
// taper-summed cross-spectrum conj(E)·M and auto-powers, each
// leave-one-taper-out MSC as total minus taper k, their clipped mean
// (the coherence), the Fisher-z jackknife mean and variance, and the
// Student-t CIs as tanh², clamped to contain the mean.  With EMG_MAX it
// takes the argmax of the coherence over m and writes the coherence and
// the CIs at that index: (W, F, E).  Otherwise it writes the full
// (W, F, E, M) grids.  The (K, F, E, M) leave-one-out tensors never reach
// device memory.
//
// What bounds it on the H100: the float32 instruction rate.  Every product
// and sum stays unfused for parity (below) and each leave-one-out ratio
// is an IEEE division (~9 instructions with its special-case check), so
// what counts is lane-instructions, not flops.  The whole jackknife is
// ~420 of them an evaluation at K = 5 (K divisions, K+1 logf, sqrtf, two
// tanhf), ~1.8 ms for the main path's 64×64 chunk (W=17, F=2049: 142.7 M
// evaluations) at 132 SMs × 128 lanes × 1.98 GHz.  The arithmetic the
// EMG-max function needs is ~83 flops an evaluation (the K cross terms,
// their totals, the K leave-one-out ratios and their mean): bounds of
// 0.177 ms at 64×64 and 0.106 ms at the task CMC's 11×64 (W=59: 85.1 M)
// at 67 TFLOP/s.
//
// What the design does about it:
// * Winner-only CIs.  The argmax reads only the coherence, so the m scan
//   of the EMG-max mode forms the K cross terms, their totals, the K
//   clipped leave-one-out ratios and their clipped mean (~150
//   lane-instructions at K = 5).  The jackknife (Fisher z, two-pass
//   variance, centre, two tanhf) then runs once per (w, f, e), for the
//   pick, by the functions the full grid runs for every m, with the
//   same operations in the same order: the EMG-max CIs are bitwise the
//   full grid's at the same pick, and the NaN of a perfectly coherent
//   pair survives.  The scan is the first form's: strict '>', the
//   first of equal maxima wins, m = 0 seeds the pick.
// * A full block at any montage.  A block serves (window, FB frequencies)
//   with L lanes per (f, e) cell and FB·E·L ≈ 256 (FB = 4 at 64×64,
//   where the first form also had 4; 11 at 11×64, where it left 212 of
//   256 threads idle).  Shared memory holds the block's EMG spectra and
//   leave-one-out EMG powers, FB·(K·M+1)·12 bytes, which at narrow
//   montages limits the threads an SM can hold; so below E = 32 a cell
//   has L = 2 lanes, lane j scanning m = j, j+2, ..., and one shuffle
//   combines the two picks as the one scan would (a NaN seed at m = 0
//   stands, else the larger value, else the smaller m).  The pick's
//   jackknife is then split between the two lanes (jackknife_pair).
//   Output stores are coalesced over (f, e).
// * Staging: the EMG spectra are copied by cp.async, all copies in
//   flight at once, while the first cell's EEG spectra load; rows are
//   m-major with the K tapers together (a lane's K loads use immediate
//   offsets) and one entry of padding per frequency (the frequencies that
//   a warp's lanes span fall in other banks).
// * The full grid runs a warp per cell, lanes over m, so its (W, F, E, M)
//   stores are consecutive (the first form stored a row of M per thread,
//   ~10× slower per 64×64 chunk).
//
// Taper counts: compile-time instances for 2 <= K <= 16 (nw <= 8.5) hold a
// cell's per-taper values in registers, every loop unrolled to K.  Above
// K = 16 the runtime-K instances run the same code (msc_block) with K a
// kernel argument, in buckets: KB = 18, 20, 24 and 32 register slots, of
// which the first KMIN = 17, 19, 21 and 25 are known to hold a taper, so
// only the last KB − KMIN carry a k < K guard (Tapers<KMIN>).  So each
// evaluation forms its K cross terms once, into registers, and reads the
// EEG spectra and leave-one-out powers it formed once per (w, f, e, k)
// from registers, as the compile-time instances do, and the EMG-max scan
// runs two lanes a cell below E = 32 as they do.  The first form of the
// runtime-K instance (one lane a cell, each cross term formed again per
// ratio, the EEG spectra re-read through L1) took 3.886-3.917 ms at K = 17
// on the main path's 64×64 chunk (W = 10); this one, bound like the
// compile-time instances by the float32 issue rate, ~1.79 ms (both on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
// What limits it further is registers: the 18-slot bucket fits 128 a
// thread (two blocks an SM), the 24- and 32-slot buckets take up to 255
// (one block an SM).  Being the same code, the runtime-K path gives the
// compile-time instances' floats bit for bit: mba_msc_jackknife_rt forces
// it at any K (K <= 16 through the <16, 2> instance) for that check.
// Beyond K = 32 msc_jackknife_any_kernel forms each per-taper value again
// where used, for any K whose EMG spectra fit a block's shared memory
// (K·M·12 bytes a frequency).
//
// Numerics: no fast math.  In float32 1 - 1e-10 == 1, so the Fisher clip
// lets c == 1 through to log(2/0) = +inf and the z variance to
// inf - inf = NaN, as in the JAX package; jnp.maximum/minimum/clip
// propagate that NaN, so the helpers below do too (fmaxf/fminf would drop
// it).  The products and sums follow the XLA kernel's formula
// (coherence.py:91-118): per taper the cross term x_k = er·mr + ei·mi
// (re) and er·mi − ei·mr (im) and the power p_k = re² + im², each product
// rounded on its own (__fmul_rn/__fadd_rn: the compiler may not contract
// them into FMAs), totals Σ_k x_k, and the leave-one-out as total − x_k.
// For a pair whose EMG spectrum equals its EEG spectrum the cross term
// and the powers are then the same floats, the ratio is exactly 1 and
// the CIs are NaN, as in the JAX package.  The variance is the two-pass
// form of the XLA kernel, Σ(z_k − z̄)², which loses less to cancellation
// than Σz² − K·z̄².  The denominator floor is max(pe·pm, 1e-30), as the
// Pallas kernel; the spectra are unscaled (the 1/(fs·N) PSD scale and
// the 1/(K−1) leave-one-out scale cancel in the ratio).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;   // (f, e) cells per block pass

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);   // NaN passes through
}

// IEEE products and sums that are never fused into an FMA
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// |x|² of one complex spectrum value
__device__ __forceinline__ float power(float2 x) {
  return add(mul(x.x, x.x), mul(x.y, x.y));
}

__device__ __forceinline__ float fisher(float c) {
  const float eps = 1e-10f;
  c = clip(c, eps, 1.0f - eps);             // upper bound rounds to 1.0f
  return __fmul_rn(0.5f, logf(__fdiv_rn(__fadd_rn(1.0f, c),
                                        __fsub_rn(1.0f, c))));
}

// Leave-taper-k-out MSC from the totals and taper k's cross term,
// clipped to [0, 1]: num >= +0 and den > 0 (or NaN), so the quotient is
// never below 0 and only the upper clamp can act
__device__ __forceinline__ float loo_ratio(float sum_cr, float sum_ci,
                                           float cr, float ci, float loo_e,
                                           float loo_m) {
  const float lcr = sub(sum_cr, cr);
  const float lci = sub(sum_ci, ci);
  const float num = add(mul(lcr, lcr), mul(lci, lci));
  // max(p, 1e-30) with NaN kept: p < 1e-30 is false for a NaN
  const float p = mul(loo_e, loo_m);
  const float den = p < 1e-30f ? 1e-30f : p;
  const float q = __fdiv_rn(num, den);
  return q > 1.f ? 1.f : q;                 // NaN passes through
}

// The taper count of an instance: K, of which the first KMIN are known at
// compile time (KMIN = K in the compile-time instances), so that only the
// slots from KMIN on carry a k < K guard
template <int KMIN>
struct Tapers {
  int K;
  __device__ __forceinline__ bool has(int k) const {
    return k < KMIN || k < K;
  }
};

// The K cross terms conj(E_k)·M_k of one (f, e, m) and their totals, in
// arrays of KB >= K slots: KB = K in the compile-time instances, a bucket
// of the runtime-K ones, whose loops run to KB under k < K guards and so
// do the same operations in the same order for the K tapers there are.
// x[k] is taper k's EEG spectrum (registers, or the staged slice in shared
// memory); v points at M_0 of this (f, m), taper k is v[k].
template <int KB>
struct Cross {
  float cr[KB], ci[KB];
  float sum_cr, sum_ci;

  template <typename X, typename TK>
  __device__ __forceinline__ Cross(const X& x, const float2* v, TK tk) {
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (tk.has(k)) {
        const float2 mk = v[k], xk = x[k];
        // conj(E)·M: re = er·mr + ei·mi, im = er·mi − ei·mr
        cr[k] = add(mul(xk.x, mk.x), mul(xk.y, mk.y));
        ci[k] = sub(mul(xk.x, mk.y), mul(xk.y, mk.x));
      }
    // totals from the first term on, without 0 + x_0: that would change
    // only the sign of an all-zero total, which every use squares away
    sum_cr = cr[0];
    sum_ci = ci[0];
#pragma unroll
    for (int k = 1; k < KB; ++k)
      if (tk.has(k)) {
        sum_cr = add(sum_cr, cr[k]);
        sum_ci = add(sum_ci, ci[k]);
      }
  }

  __device__ __forceinline__ float loo(int k, float loo_e, float loo_m)
      const {
    return loo_ratio(sum_cr, sum_ci, cr[k], ci[k], loo_e, loo_m);
  }
};

// The coherence: the clipped mean of the K leave-one-out ratios (each
// >= +0 or NaN, so the sum starts at the first).  All the argmax over m
// reads.
template <int KB, typename LE, typename TK>
__device__ __forceinline__ float coherence_mean(const Cross<KB>& x,
                                               const LE& loo_e,
                                               const float* loo_m, TK tk) {
  float sum_c = x.loo(0, loo_e[0], loo_m[0]);
#pragma unroll
  for (int k = 1; k < KB; ++k)
    if (tk.has(k)) sum_c = add(sum_c, x.loo(k, loo_e[k], loo_m[k]));
  return clip(mul(sum_c, 1.0f / tk.K), 0.f, 1.f);
}

// The jackknife from its K terms (c_k and its Fisher z_k): the
// coherence, the z standard error (two-pass variance) and the centre
template <int KB, typename TK>
__device__ __forceinline__ void jk_centre(const float (&c)[KB],
                                          const float (&z)[KB], TK tk,
                                          float& cm, float& z_se,
                                          float& zc) {
  float sum_c = c[0], sum_z = z[0];         // each >= +0 or NaN
#pragma unroll
  for (int k = 1; k < KB; ++k)
    if (tk.has(k)) {
      sum_c = add(sum_c, c[k]);
      sum_z = add(sum_z, z[k]);
    }
  cm = clip(mul(sum_c, 1.0f / tk.K), 0.f, 1.f);
  const float z_mean = mul(sum_z, 1.0f / tk.K);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < KB; ++k)
    if (tk.has(k)) {
      const float d = sub(z[k], z_mean);
      ss = __fmaf_rn(d, d, ss);
    }
  z_se = __fsqrt_rn(mul((tk.K - 1.0f) / tk.K, ss));
  zc = fisher(cm);
}

// The whole jackknife of one (f, e, m): coherence and both CIs.  The
// full grid and the EMG-max pick reach the CIs through this function or
// through jackknife_pair, which forms the same floats in two lanes.
template <int KB, typename LE, typename TK>
__device__ __forceinline__ void jackknife(const Cross<KB>& x,
                                          const LE& loo_e,
                                          const float* loo_m, TK tk,
                                          float t_crit, float& cm,
                                          float& cl, float& cu) {
  float c[KB], z[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k)
    if (tk.has(k)) {
      c[k] = x.loo(k, loo_e[k], loo_m[k]);
      z[k] = fisher(c[k]);
    }
  float z_se, zc;
  jk_centre<KB>(c, z, tk, cm, z_se, zc);
  const float tl = tanhf(__fmaf_rn(-t_crit, z_se, zc));
  const float th = tanhf(__fmaf_rn(t_crit, z_se, zc));
  cl = nan_min(mul(tl, tl), cm);
  cu = nan_max(mul(th, th), cm);
}

// jackknife() shared by the two lanes j = 0, 1 of `pair`: lane j forms
// the terms of the tapers k = 2i + j and one of the two tanhf, on
// operands picked by select so that both lanes run one instruction
// stream, and the lanes swap what they formed.  Every value is the
// float jackknife() forms, by the same functions on the same operands.
template <int KB, typename LE, typename TK>
__device__ __forceinline__ void jackknife_pair(const Cross<KB>& x,
                                               const LE& loo_e,
                                               const float* loo_m, TK tk,
                                               float t_crit, int j,
                                               unsigned pair, float& cm,
                                               float& cl, float& cu) {
  float c[KB], z[KB];
#pragma unroll
  for (int i = 0; i < (KB + 1) / 2; ++i) {
    const int k0 = 2 * i;
    if (!tk.has(k0)) continue;                 // K is the pair's
    // lane 1's taper, k0 + 1, or k0 itself (idling) at k0 + 1 = K; the
    // register arrays are indexed by constants only (kn), a runtime K
    // picks between them
    constexpr int kn_max = KB - 1;
    const int kn = k0 + 1 < kn_max ? k0 + 1 : kn_max;
    const bool has1 = tk.has(k0 + 1);
    const int k1 = has1 ? k0 + 1 : k0;
    const float ck = loo_ratio(x.sum_cr, x.sum_ci,
                               j && has1 ? x.cr[kn] : x.cr[k0],
                               j && has1 ? x.ci[kn] : x.ci[k0],
                               j && has1 ? loo_e[kn] : loo_e[k0],
                               j ? loo_m[k1] : loo_m[k0]);
    const float zk = fisher(ck);
    const float oc = __shfl_xor_sync(pair, ck, 1);
    const float oz = __shfl_xor_sync(pair, zk, 1);
    c[k0] = j ? oc : ck;
    z[k0] = j ? oz : zk;
    if (has1) {                                // then k1 = kn = k0 + 1
      c[kn] = j ? ck : oc;
      z[kn] = j ? zk : oz;
    }
  }
  float z_se, zc;
  jk_centre<KB>(c, z, tk, cm, z_se, zc);
  // lane 0 the lower bound's tanhf, lane 1 the upper's
  const float t = tanhf(__fmaf_rn(j ? t_crit : -t_crit, z_se, zc));
  const float ot = __shfl_xor_sync(pair, t, 1);
  const float tl = j ? ot : t, th = j ? t : ot;
  cl = nan_min(mul(tl, tl), cm);
  cu = nan_max(mul(th, th), cm);
}

// The K EEG spectra of one (f, e) and their leave-one-out powers, formed
// once per (w, f, e, k) and held in registers for the cell's whole scan
template <int KB, typename TK>
__device__ __forceinline__ void load_eeg(const float2* __restrict__ eeg,
                                         size_t wk, int F, int E, int f,
                                         int e, TK tk, float2 (&x)[KB],
                                         float (&loo_e)[KB]) {
  float sum_e = 0.f;
#pragma unroll
  for (int k = 0; k < KB; ++k)
    if (tk.has(k)) {
      x[k] = eeg[((wk + k) * F + f) * E + e];
      sum_e = add(sum_e, power(x[k]));
    }
#pragma unroll
  for (int k = 0; k < KB; ++k)
    if (tk.has(k)) loo_e[k] = sub(sum_e, power(x[k]));
}

// One block's work: (window blockIdx.y, FB frequencies from blockIdx.x·FB),
// tk.K <= KB tapers.  The compile-time instances call it with K = KB, the
// runtime-K ones with the chunk's K and a bucket KB.
template <int KB, bool EMG_MAX, typename TK>
__device__ __forceinline__ void msc_block(const float2* __restrict__ eeg,
                                          const float2* __restrict__ emg,
                                          float* __restrict__ coh,
                                          float* __restrict__ lo,
                                          float* __restrict__ hi, TK tk,
                                          int F, int E, int M, int FB,
                                          int L, float t_crit) {
  const int K = tk.K;
  extern __shared__ float4 smem[];
  // per frequency a row of M·K entries, m-major, K tapers together, plus
  // one of padding so that the rows of neighbouring frequencies start in
  // other banks: EMG spectra [FB][RS], then leave-one-out powers [FB][RS]
  const int RS = M * K + 1;
  float2* ms = reinterpret_cast<float2*>(smem);
  float* loo_m = reinterpret_cast<float*>(ms + FB * RS);

  const int w = blockIdx.y;
  const int f0 = blockIdx.x * FB;
  const size_t wk = (size_t)w * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int fb = F - f0 < FB ? F - f0 : FB;           // real frequencies
  const int cells = fb * E;

  // this thread's (f, e) cells: EMG-max, L lanes a cell; full grid, a
  // warp a cell.  The first cell's EEG spectra load while the EMG
  // spectra are copied.
  const int c_first = EMG_MAX ? threadIdx.x / L : warp;
  const int c_step = EMG_MAX ? blockDim.x / L : n_warps;
  float2 x[KB];
  float loo_e[KB];
  if (c_first < cells)
    load_eeg<KB>(eeg, wk, F, E, f0 + c_first / E, c_first % E, tk, x, loo_e);

  // stage the block's EMG spectra, a row of 32 m (one frequency) a warp,
  // the K tapers unrolled, by cp.async: every copy is in flight at once;
  // then, laid out the same way, their leave-one-out powers
  const size_t taper = (size_t)F * M;               // emg: taper k → k+1
  const int m_rows = (M + 31) / 32;                  // rows of 32 m
  for (int r = warp; r < fb * m_rows; r += n_warps) {
    const int fi = r / m_rows, m = (r - fi * m_rows) * 32 + lane;
    if (m >= M) continue;
    const float2* src = emg + (wk * F + f0 + fi) * M + m;
    float2* dst = ms + fi * RS + m * K;
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (tk.has(k)) cp_async8(dst + k, src + k * taper);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  for (int fi = warp; fi < fb; fi += n_warps)
    for (int m = lane; m < M; m += 32) {
      const float2* v = ms + fi * RS + m * K;
      float sum = power(v[0]);
#pragma unroll
      for (int k = 1; k < KB; ++k)
        if (tk.has(k)) sum = add(sum, power(v[k]));
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (tk.has(k)) loo_m[fi * RS + m * K + k] = sub(sum, power(v[k]));
    }
  __syncthreads();

  for (int c = c_first; c < cells; c += c_step) {
    const int fi = c / E, e = c - fi * E;
    if (c != c_first) load_eeg<KB>(eeg, wk, F, E, f0 + fi, e, tk, x, loo_e);
    const float2* ms_f = ms + fi * RS;
    const float* lm_f = loo_m + fi * RS;
    if (EMG_MAX) {
      // L lanes a cell (1, or 2 at narrow montages), lane j scanning
      // m = j, j + L, ...: the scan of m = 0, 1, ... in pieces.  m = 0
      // seeds the pick; a later m takes it only when strictly larger; a
      // lane whose first m is not 0 starts with no pick.
      const int j = threadIdx.x % L;
      float best_c = -INFINITY;
      int best_m = -1;
      if (j == 0) {
        best_c = coherence_mean<KB>(Cross<KB>(x, ms_f, tk), loo_e, lm_f, tk);
        best_m = 0;
      }
      for (int m = j == 0 ? L : j; m < M; m += L) {
        const float cm = coherence_mean<KB>(Cross<KB>(x, ms_f + m * K, tk),
                                            loo_e, lm_f + m * K, tk);
        if (cm > best_c) {
          best_c = cm;
          best_m = m;
        }
      }
      if (L == 2) {
        // the pair's picks (a: even m, seeded at 0; b: odd m), combined
        // as the one scan would: a NaN seed stands, else the larger
        // value, else on a tie the smaller m
        const unsigned pair = 3u << (lane & 30);
        const float oc = __shfl_xor_sync(pair, best_c, 1);
        const int om = __shfl_xor_sync(pair, best_m, 1);
        const float ac = j ? oc : best_c, bc = j ? best_c : oc;
        const int am = j ? om : best_m, bm = j ? best_m : om;
        const bool take_b = ac == ac && bm >= 0
            && (bc > ac || (bc == ac && bm < am));
        best_m = take_b ? bm : am;
      }
      float cm, cl, cu;
      const Cross<KB> pick(x, ms_f + best_m * K, tk);
      if (L == 2)
        jackknife_pair<KB>(pick, loo_e, lm_f + best_m * K, tk, t_crit, j,
                           3u << (lane & 30), cm, cl, cu);
      else
        jackknife<KB>(pick, loo_e, lm_f + best_m * K, tk, t_crit, cm, cl,
                      cu);
      if (j == 0) {
        const size_t cell = ((size_t)w * F + f0) * E + c;
        coh[cell] = cm;                     // the pick's value, bit for bit
        lo[cell] = cl;
        hi[cell] = cu;
      }
    } else {
      // lanes over m: a warp's (W, F, E, M) stores are consecutive
      const size_t row = (((size_t)w * F + f0) * E + c) * M;
      for (int m = lane; m < M; m += 32) {
        float cm, cl, cu;
        jackknife<KB>(Cross<KB>(x, ms_f + m * K, tk), loo_e, lm_f + m * K, tk,
                      t_crit, cm, cl, cu);
        coh[row + m] = cm;
        lo[row + m] = cl;
        hi[row + m] = cu;
      }
    }
  }
}

// The compile-time instances: K tapers, every loop unrolled to K
template <int K, bool EMG_MAX>
__global__ void __launch_bounds__(THREADS)
msc_jackknife_kernel(const float2* __restrict__ eeg,
                     const float2* __restrict__ emg,
                     float* __restrict__ coh, float* __restrict__ lo,
                     float* __restrict__ hi, int F, int E, int M, int FB,
                     int L, float t_crit) {
  msc_block<K, EMG_MAX>(eeg, emg, coh, lo, hi, Tapers<K>{K}, F, E, M, FB, L,
                        t_crit);
}

// The runtime-K instances: KMIN <= K <= KB tapers, the loops unrolled to
// the bucket KB, the slots from KMIN on under k < K guards; the same code
// as the compile-time instances, so that the two agree bit for bit where
// both run (the <16, 2> instance serves every K <= 16 for that check)
template <int KB, int KMIN, bool EMG_MAX>
__global__ void __launch_bounds__(THREADS, KB <= 20 ? 2 : 1)
msc_jackknife_rt_kernel(const float2* __restrict__ eeg,
                        const float2* __restrict__ emg,
                        float* __restrict__ coh, float* __restrict__ lo,
                        float* __restrict__ hi, int K, int F, int E, int M,
                        int FB, int L, float t_crit) {
  msc_block<KB, EMG_MAX>(eeg, emg, coh, lo, hi, Tapers<KMIN>{K}, F, E, M,
                         FB, L, t_crit);
}

// ---- beyond the largest bucket: any K --------------------------------

// One (w, f, e) cell's EEG spectra, re-read where used: taper k at
// x[k · xs]; sum_e their total power as load_eeg forms it
struct CellRT {
  const float2* x;
  size_t xs;
  int K;
  float sum_e;

  __device__ __forceinline__ CellRT(const float2* eeg, size_t wk, int F,
                                    int E, int f, int e, int K_)
      : x(eeg + (wk * F + f) * E + e), xs((size_t)F * E), K(K_) {
    sum_e = 0.f;
    for (int k = 0; k < K; ++k) sum_e = add(sum_e, power(x[k * xs]));
  }
  __device__ __forceinline__ float2 spec(int k) const {
    return __ldg(x + k * xs);
  }
};

// Cross<K>'s terms for taper k, and its totals
__device__ __forceinline__ void cross_term(const CellRT& c, const float2* v,
                                           int k, float& cr, float& ci) {
  const float2 e = c.spec(k), mk = v[k];
  cr = add(mul(e.x, mk.x), mul(e.y, mk.y));
  ci = sub(mul(e.x, mk.y), mul(e.y, mk.x));
}

__device__ __forceinline__ void cross_sums(const CellRT& c, const float2* v,
                                           float& sum_cr, float& sum_ci) {
  cross_term(c, v, 0, sum_cr, sum_ci);
  for (int k = 1; k < c.K; ++k) {
    float cr, ci;
    cross_term(c, v, k, cr, ci);
    sum_cr = add(sum_cr, cr);
    sum_ci = add(sum_ci, ci);
  }
}

// Cross<K>::loo with taper k's terms and powers formed again
__device__ __forceinline__ float loo_rt(const CellRT& c, const float2* v,
                                        const float* loo_m, float sum_cr,
                                        float sum_ci, int k) {
  float cr, ci;
  cross_term(c, v, k, cr, ci);
  return loo_ratio(sum_cr, sum_ci, cr, ci, sub(c.sum_e, power(c.spec(k))),
                   loo_m[k]);
}

__device__ __forceinline__ float coherence_mean_rt(const CellRT& c,
                                                   const float2* v,
                                                   const float* loo_m) {
  float sum_cr, sum_ci;
  cross_sums(c, v, sum_cr, sum_ci);
  float sum_c = loo_rt(c, v, loo_m, sum_cr, sum_ci, 0);
  for (int k = 1; k < c.K; ++k)
    sum_c = add(sum_c, loo_rt(c, v, loo_m, sum_cr, sum_ci, k));
  return clip(mul(sum_c, 1.0f / c.K), 0.f, 1.f);
}

// jackknife() in two passes over the tapers: the sums, then the
// variance about the z mean, each c_k and z_k formed again
__device__ __forceinline__ void jackknife_rt(const CellRT& c,
                                             const float2* v,
                                             const float* loo_m,
                                             float t_crit, float& cm,
                                             float& cl, float& cu) {
  const int K = c.K;
  float sum_cr, sum_ci;
  cross_sums(c, v, sum_cr, sum_ci);
  float sum_c = loo_rt(c, v, loo_m, sum_cr, sum_ci, 0);
  float sum_z = fisher(sum_c);
  for (int k = 1; k < K; ++k) {
    const float ck = loo_rt(c, v, loo_m, sum_cr, sum_ci, k);
    sum_c = add(sum_c, ck);
    sum_z = add(sum_z, fisher(ck));
  }
  cm = clip(mul(sum_c, 1.0f / K), 0.f, 1.f);
  const float z_mean = mul(sum_z, 1.0f / K);
  float ss = 0.f;
  for (int k = 0; k < K; ++k) {
    const float d =
        sub(fisher(loo_rt(c, v, loo_m, sum_cr, sum_ci, k)), z_mean);
    ss = __fmaf_rn(d, d, ss);
  }
  const float z_se = __fsqrt_rn(mul((K - 1.0f) / K, ss));
  const float zc = fisher(cm);
  const float tl = tanhf(__fmaf_rn(-t_crit, z_se, zc));
  const float th = tanhf(__fmaf_rn(t_crit, z_se, zc));
  cl = nan_min(mul(tl, tl), cm);
  cu = nan_max(mul(th, th), cm);
}

template <bool EMG_MAX>
__global__ void __launch_bounds__(THREADS)
msc_jackknife_any_kernel(const float2* __restrict__ eeg,
                        const float2* __restrict__ emg,
                        float* __restrict__ coh, float* __restrict__ lo,
                        float* __restrict__ hi, int K, int F, int E, int M,
                        int FB, float t_crit) {
  extern __shared__ float4 smem[];
  const int RS = M * K + 1;             // as msc_jackknife_kernel's rows
  float2* ms = reinterpret_cast<float2*>(smem);
  float* loo_m = reinterpret_cast<float*>(ms + FB * RS);

  const int w = blockIdx.y;
  const int f0 = blockIdx.x * FB;
  const size_t wk = (size_t)w * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int fb = F - f0 < FB ? F - f0 : FB;
  const int cells = fb * E;

  const size_t taper = (size_t)F * M;
  const int m_rows = (M + 31) / 32;
  for (int r = warp; r < fb * m_rows; r += n_warps) {
    const int fi = r / m_rows, m = (r - fi * m_rows) * 32 + lane;
    if (m >= M) continue;
    const float2* src = emg + (wk * F + f0 + fi) * M + m;
    float2* dst = ms + fi * RS + m * K;
    for (int k = 0; k < K; ++k) cp_async8(dst + k, src + k * taper);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  for (int fi = warp; fi < fb; fi += n_warps)
    for (int m = lane; m < M; m += 32) {
      const float2* v = ms + fi * RS + m * K;
      float sum = power(v[0]);
      for (int k = 1; k < K; ++k) sum = add(sum, power(v[k]));
      for (int k = 0; k < K; ++k)
        loo_m[fi * RS + m * K + k] = sub(sum, power(v[k]));
    }
  __syncthreads();

  const int c_first = EMG_MAX ? threadIdx.x : warp;
  const int c_step = EMG_MAX ? blockDim.x : n_warps;
  for (int c = c_first; c < cells; c += c_step) {
    const int fi = c / E, e = c - fi * E;
    const CellRT x(eeg, wk, F, E, f0 + fi, e, K);
    const float2* ms_f = ms + fi * RS;
    const float* lm_f = loo_m + fi * RS;
    if (EMG_MAX) {
      // the scan of msc_jackknife_kernel at L = 1
      float best_c = coherence_mean_rt(x, ms_f, lm_f);
      int best_m = 0;
      for (int m = 1; m < M; ++m) {
        const float cm = coherence_mean_rt(x, ms_f + m * K, lm_f + m * K);
        if (cm > best_c) {
          best_c = cm;
          best_m = m;
        }
      }
      float cm, cl, cu;
      jackknife_rt(x, ms_f + best_m * K, lm_f + best_m * K, t_crit, cm, cl,
                   cu);
      const size_t cell = ((size_t)w * F + f0) * E + c;
      coh[cell] = cm;
      lo[cell] = cl;
      hi[cell] = cu;
    } else {
      const size_t row = (((size_t)w * F + f0) * E + c) * M;
      for (int m = lane; m < M; m += 32) {
        float cm, cl, cu;
        jackknife_rt(x, ms_f + m * K, lm_f + m * K, t_crit, cm, cl, cu);
        coh[row + m] = cm;
        lo[row + m] = cl;
        hi[row + m] = cu;
      }
    }
  }
}

// Shared memory of a block of FB frequencies: the EMG spectra and their
// leave-one-out powers
__host__ size_t block_smem(int K, int M, int FB) {
  return (size_t)FB * ((size_t)K * M + 1) * (sizeof(float2) + sizeof(float));
}

// FB frequencies a block: ~cells (f, e) cells, within the shared memory a
// block may hold and the F frequencies there are; 0 where one frequency
// does not fit
__host__ int frequencies_a_block(int K, int F, int E, int M, int cells,
                                 int smem_max) {
  int FB = E >= cells ? 1 : cells / E;
  while (FB > 0 && block_smem(K, M, FB) > (size_t)smem_max) --FB;
  return FB < F ? FB : F;
}

__host__ cudaError_t optin_smem(int& smem_max) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&smem_max,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
}

template <bool EMG_MAX>
cudaError_t launch_any(const float2* eeg, const float2* emg, float* coh,
                       float* lo, float* hi, int W, int K, int F, int E,
                       int M, float t_crit, cudaStream_t stream) {
  auto kernel = msc_jackknife_any_kernel<EMG_MAX>;
  int smem_max = 0;
  cudaError_t err = optin_smem(smem_max);
  if (err != cudaSuccess) return err;
  const int FB = frequencies_a_block(K, F, E, M, THREADS, smem_max);
  if (FB < 1) return cudaErrorInvalidValue;     // K·M too large to stage
  const size_t smem = block_smem(K, M, FB);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((F + FB - 1) / FB, W);
  kernel<<<grid, THREADS, smem, stream>>>(eeg, emg, coh, lo, hi, K, F, E, M,
                                          FB, t_crit);
  return cudaGetLastError();
}

// One launch of the compile-time instance (KMIN = KB = K) or of the
// runtime-K one of bucket KB (KMIN < KB, KMIN <= K <= KB)
template <int KB, int KMIN, bool EMG_MAX>
cudaError_t launch(const float2* eeg, const float2* emg, float* coh,
                   float* lo, float* hi, int W, int K, int F, int E, int M,
                   float t_crit, cudaStream_t stream) {
  int smem_max = 0;
  cudaError_t err = optin_smem(smem_max);
  if (err != cudaSuccess) return err;
  // FB frequencies a block: ~THREADS working (f, e) threads.  Lanes per
  // (f, e) in the EMG-max scan: 2 where E is narrow, so a block's shared
  // memory serves twice the threads
  const int L = EMG_MAX && E < 32 ? 2 : 1;
  const int FB = frequencies_a_block(K, F, E, M, THREADS / L, smem_max);
  if (FB < 1) return cudaErrorInvalidValue;     // M too large to stage
  const size_t smem = block_smem(K, M, FB);
  const dim3 grid((F + FB - 1) / FB, W);
  if constexpr (KMIN < KB) {
    auto kernel = msc_jackknife_rt_kernel<KB, KMIN, EMG_MAX>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, THREADS, smem, stream>>>(eeg, emg, coh, lo, hi, K, F, E,
                                            M, FB, L, t_crit);
  } else {
    auto kernel = msc_jackknife_kernel<KB, EMG_MAX>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, THREADS, smem, stream>>>(eeg, emg, coh, lo, hi, F, E, M,
                                            FB, L, t_crit);
  }
  return cudaGetLastError();
}

template <int KB, int KMIN>
cudaError_t launch_k(const void* eeg, const void* emg, void* coh, void* lo,
                     void* hi, int W, int K, int F, int E, int M,
                     float t_crit, int emg_max, cudaStream_t stream) {
  const float2* e = static_cast<const float2*>(eeg);
  const float2* m = static_cast<const float2*>(emg);
  float* c = static_cast<float*>(coh);
  float* l = static_cast<float*>(lo);
  float* h = static_cast<float*>(hi);
  return emg_max
      ? launch<KB, KMIN, true>(e, m, c, l, h, W, K, F, E, M, t_crit, stream)
      : launch<KB, KMIN, false>(e, m, c, l, h, W, K, F, E, M, t_crit,
                                stream);
}

// The runtime-K path: the bucket that holds K (K <= 16 only when forced,
// for the bit-for-bit check), else (K > 32) msc_jackknife_any_kernel
int launch_runtime_k(const void* eeg, const void* emg, void* coh, void* lo,
                     void* hi, int W, int K, int F, int E, int M,
                     float t_crit, int emg_max, cudaStream_t s) {
  if (K <= 16)
    return (int)launch_k<16, 2>(eeg, emg, coh, lo, hi, W, K, F, E, M,
                                t_crit, emg_max, s);
  if (K <= 18)
    return (int)launch_k<18, 17>(eeg, emg, coh, lo, hi, W, K, F, E, M,
                                 t_crit, emg_max, s);
  if (K <= 20)
    return (int)launch_k<20, 19>(eeg, emg, coh, lo, hi, W, K, F, E, M,
                                 t_crit, emg_max, s);
  if (K <= 24)
    return (int)launch_k<24, 21>(eeg, emg, coh, lo, hi, W, K, F, E, M,
                                 t_crit, emg_max, s);
  if (K <= 32)
    return (int)launch_k<32, 25>(eeg, emg, coh, lo, hi, W, K, F, E, M,
                                 t_crit, emg_max, s);
  const float2* e = static_cast<const float2*>(eeg);
  const float2* m = static_cast<const float2*>(emg);
  float* c = static_cast<float*>(coh);
  float* l = static_cast<float*>(lo);
  float* h = static_cast<float*>(hi);
  return (int)(emg_max
      ? launch_any<true>(e, m, c, l, h, W, K, F, E, M, t_crit, s)
      : launch_any<false>(e, m, c, l, h, W, K, F, E, M, t_crit, s));
}

bool valid(int W, int K, int F, int E, int M) {
  return W > 0 && W <= 65535 && F > 0 && E > 0 && M > 0 && K >= 2;
}

}  // namespace

extern "C" int mba_msc_jackknife(const void* eeg, const void* emg,
                                 void* coh, void* lo, void* hi, int W,
                                 int K, int F, int E, int M, float t_crit,
                                 int emg_max, void* stream) {
  if (!valid(W, K, F, E, M)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MBA_CASE(k)                                                       \
  case k:                                                                 \
    return (int)launch_k<k, k>(eeg, emg, coh, lo, hi, W, K, F, E, M,      \
                               t_crit, emg_max, s);
  switch (K) {
    MBA_CASE(2) MBA_CASE(3) MBA_CASE(4) MBA_CASE(5) MBA_CASE(6) MBA_CASE(7)
    MBA_CASE(8) MBA_CASE(9) MBA_CASE(10) MBA_CASE(11) MBA_CASE(12)
    MBA_CASE(13) MBA_CASE(14) MBA_CASE(15) MBA_CASE(16)
    default:
      return launch_runtime_k(eeg, emg, coh, lo, hi, W, K, F, E, M, t_crit,
                              emg_max, s);
  }
#undef MBA_CASE
}

// The runtime-K path at any K >= 2, also where a compile-time instance
// exists: for holding the two to each other bit for bit
extern "C" int mba_msc_jackknife_rt(const void* eeg, const void* emg,
                                    void* coh, void* lo, void* hi, int W,
                                    int K, int F, int E, int M,
                                    float t_crit, int emg_max,
                                    void* stream) {
  if (!valid(W, K, F, E, M)) return (int)cudaErrorInvalidValue;
  return launch_runtime_k(eeg, emg, coh, lo, hi, W, K, F, E, M, t_crit,
                          emg_max, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
