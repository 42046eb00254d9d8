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
// diag (F, N), pr and pi (P2, F, N), N = E·M, frequency-major.  With
// `accumulate` the kernel adds its sums to what the outputs hold (out + sum,
// one rounding, as the plain version's out.add_(sum)), so a caller sums its
// chunks in place.  The (wc, K, F, N) products never reach device memory.
//
// What bounds it on the H100: float32 issue on the CUDA cores, and the
// latency of the IEEE division and sqrtf that the parity rules keep: each
// is a short chain (reciprocal or root estimate, Newton steps, a range
// check that branches to a slow path), so a cell-window is ~100
// instructions at K = 5 of which ~20 form one dependent chain, and the
// chains of a thread's cells cannot be interleaved across their branches.
// The main path's chunk (wc=32, K=5, F=175, 64×64) is 22.9 M cell-windows
// against 29 MB of spectra and 60 MB of sums.  The first form (one cell a
// thread, one window per barrier pair, 68 of 256 threads staging each
// window with serial loads) took 0.445 ms; this one 0.146 ms, a third of
// the flop bound (both on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
//
// The design:
// * A thread owns a TE × TM micro-tile of cells (Tile<K>), so each staged
//   EEG value serves TM cells and each EMG value TE; its (1 + 2·P2)·TE·TM
//   sums stay in registers over the chunk, each product added by one FMA.
//   Lanes run along m (stride LM between a thread's m), so a warp's EMG
//   reads and its stores are consecutive and its EEG reads are broadcasts.
//   The micro-tile is small enough for 12-16 resident warps an SM, which
//   hide each other's division chains.
// * A unit is (frequency, EB EEG × MB EMG tile), EB = WARPS · (32 / LM) ·
//   TE, MB = LM · TM: 16 × 32 cells at K = 5 and M = 64.  Where LM = 32
//   (M > 16·TM) the tile is a compile-time shape (WIDE), so every
//   shared-memory offset folds into the load.  The grid is persistent: as
//   many blocks as the card holds at once, each walking units blockIdx,
//   blockIdx + gridDim, ...; blocks that share an SM share its issue
//   slots, so each SM's total differs from the mean by less than one unit,
//   and the ring below runs on across a block's units.
// * Windows arrive in groups of G through a ring of STAGES groups in
//   dynamic shared memory, copied by cp.async by the whole block (16 bytes
//   a copy where E and M are even and the spectra 16-byte aligned, else 8),
//   zero-filled past wc, E and M: group g+1 is in flight while g is
//   computed.  Once a group has landed the block forms each window's
//   channel powers pe/pm and stages its weights in shared memory; two
//   barriers a group, not two a window.
//
// Taper counts: compile-time instances for 2 <= K <= 16 (nw <= 8.5).  Above
// K = 8 a thread owns one cell, with 4 warps a block and the register cap
// lifted to 255 (one block an SM guaranteed): its 1 + K(K−1) sums still
// grow past the register file from K ≈ 12 on, and ptxas spills the rest
// (chip_smoke.ptxas_report prints registers and spills per instance).
// Above K = 16 one runtime-K instance takes any K: a thread a cell, the
// pairs in blocks of PAIR_BLOCK sums held in registers, each block a pass
// over the chunk's windows with the spectra re-read from device memory
// (L1/L2) and the powers formed again; the diagonal is the first pass.
//
// Numerics as the plain version's: no fast math.  The clamp is
// NaN-propagating, as jnp.maximum: a NaN spectrum gives NaN sums even in a
// zero-weight window, which is evaluated like any other.  IEEE division
// and sqrtf (a zero weight gives their exact result, ±0 or NaN, without
// the division; see the window loop); denormals are kept (no -ftz), so a
// denormal pe·pm clamps to FLT_MIN as on the CPU.  Sums run in window
// order, one thread a cell: no atomics, deterministic.  The products are
// fused into FMAs, which the plain version does not: agreement is to
// float32 rounding, stated with the wrapper.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int G = 8;           // windows per group
constexpr int STAGES = 2;      // groups in the ring
constexpr int ACC_BATCH = 8;   // pairs of old sums read together

// The shape per K: TE EEG × TM EMG cells a thread (powers of two), so
// that a thread's (1 + 2·P2)·TE·TM sums stay near 64 registers; WARPS a
// block; and the blocks an SM must hold, which bounds the registers
// (16 warps an SM: 128 a thread; 12: 168).  Tuned on the H100 at K = 5
// (PERF.md): 8 warps of 2 × 1 cells, two blocks an SM.
template <int K>
struct Tile {
  static constexpr int TE = K <= 6 ? 2 : 1;
  static constexpr int TM = K <= 4 ? 2 : 1;
  static constexpr int WARPS = K <= 5 ? 8 : 4;
  static constexpr int MIN_BLOCKS = K <= 5 ? 2 : (K <= 8 ? 3 : 1);
};

struct Geom {
  int wc, F, E, M;
  int EB, MB, log_eb, log_mb;  // block tile (powers of two)
  int log_lm;                  // lanes along m: LM = 1 << log_lm
  int units_e, units_m, n_units, groups;
  int slot_floats;             // one ring slot, a multiple of 4 floats
  int vec, accumulate;
};

__host__ __device__ constexpr int ilog2(int x) {   // x a power of two
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// floats of one ring slot: E [G·K][EB] and M [G·K][MB] (float2), pe [G][EB],
// pm [G][MB], w [G], rounded up to 16 bytes
__host__ __device__ constexpr int slot_floats_of(int K, int EB, int MB) {
  return (2 * G * K * (EB + MB) + G * (EB + MB) + G + 3) / 4 * 4;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the rows (window win0 + r / K, taper r % K) of channels
// c0..c0+CB at frequency f into dst[r][CB] (float2), r < G·K; zero past
// wc (row wc·K on) and past C.  Rows of one window and taper are
// consecutive in memory: row r of the group is (win0·K + r) in the
// (wc·K, F, C) view.
template <int K, int THREADS>
__device__ __forceinline__ void copy_rows(float2* dst, const float2* src,
                                          int C, int c0, int log_cb, int f,
                                          int F, int win0, int wc, bool vec,
                                          int t) {
  const int per = vec ? 2 : 1;                       // channels a copy
  const int log_q = log_cb - (vec ? 1 : 0);          // copies a row: 2^log_q
  const int items = G * K << log_q;
  for (int i = t; i < items; i += THREADS) {
    const int r = i >> log_q;
    const int c = (i & ((1 << log_q) - 1)) * per;
    const int row = win0 * K + r;
    const bool ok = row < wc * K && c0 + c < C;
    const float2* s = ok ? src + ((size_t)row * F + f) * C + c0 + c : src;
    cp_async(dst + (r << log_cb) + c, s, 8 * per, ok ? 8 * per : 0);
  }
}

template <int K, int TE, int TM, bool WIDE>
__global__ void __launch_bounds__(32 * Tile<K>::WARPS, Tile<K>::MIN_BLOCKS)
coeff_pairs_kernel(const float2* __restrict__ eeg,
                   const float2* __restrict__ emg,
                   const float* __restrict__ weights,
                   float* __restrict__ diag, float* __restrict__ pr,
                   float* __restrict__ pi, const Geom g) {
  constexpr int P2 = K * (K - 1) / 2;
  constexpr int WARPS = Tile<K>::WARPS, THREADS = 32 * WARPS;
  // the block tile: compile-time where the lanes span 32 EMG channels
  // (WIDE, as at M = 64), so every shared-memory offset below folds
  const int log_lm = WIDE ? 5 : g.log_lm;
  const int EB = WIDE ? WARPS * TE : g.EB;
  const int MB = WIDE ? 32 * TM : g.MB;
  const int log_eb = WIDE ? ilog2(WARPS * TE) : g.log_eb;
  const int log_mb = WIDE ? ilog2(32 * TM) : g.log_mb;
  const int slot_floats =
      WIDE ? slot_floats_of(K, WARPS * TE, 32 * TM) : g.slot_floats;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  // one slot: E [G·K][EB], M [G·K][MB] (float2), pe [G][EB], pm [G][MB],
  // w [G]
  const int off_m = 2 * G * K * EB;
  const int off_pe = off_m + 2 * G * K * MB;
  const int off_pm = off_pe + G * EB;
  const int off_w = off_pm + G * MB;

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int LM = 1 << log_lm, LE = 32 >> log_lm;
  const int lm = lane & (LM - 1);
  const int el0 = (warp * LE + (lane >> log_lm)) * TE;  // first local e

  const int my_units = (int)blockIdx.x < g.n_units
      ? (g.n_units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = my_units * g.groups;
  const int per_f = g.units_e * g.units_m;
  // step → its unit's (f, e0, m0) and its group within the unit
  auto locate = [&](int step, int& f, int& e0, int& m0, int& grp) {
    const int i = step / g.groups;
    grp = step - i * g.groups;
    const int u = blockIdx.x + i * gridDim.x;
    f = u / per_f;
    const int r = u - f * per_f;
    const int ue = r / g.units_m;
    e0 = ue * EB;
    m0 = (r - ue * g.units_m) * MB;
  };
  auto stage = [&](int step) {
    int f, e0, m0, grp;
    locate(step, f, e0, m0, grp);
    float* slot = smem + (step % STAGES) * slot_floats;
    copy_rows<K, THREADS>(reinterpret_cast<float2*>(slot), eeg, g.E, e0,
                          log_eb, f, g.F, grp * G, g.wc, g.vec, t);
    copy_rows<K, THREADS>(reinterpret_cast<float2*>(slot + off_m), emg, g.M,
                          m0, log_mb, f, g.F, grp * G, g.wc, g.vec, t);
  };

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < steps) stage(p);
    cp_async_commit();
  }

  float d[TE][TM], ar[TE][TM][P2], ai[TE][TM][P2];
#pragma unroll
  for (int a = 0; a < TE; ++a)
#pragma unroll
    for (int b = 0; b < TM; ++b) {
      d[a][b] = 0.f;
#pragma unroll
      for (int p = 0; p < P2; ++p) ar[a][b][p] = ai[a][b][p] = 0.f;
    }

  const int nC = EB + MB;
  for (int step = 0; step < steps; ++step) {
    int f, e0, m0, grp;
    locate(step, f, e0, m0, grp);
    float* slot = smem + (step % STAGES) * slot_floats;
    const float2* Es = reinterpret_cast<const float2*>(slot);
    const float2* Ms = reinterpret_cast<const float2*>(slot + off_m);
    float* pes = slot + off_pe;
    float* pms = slot + off_pm;
    float* ws = slot + off_w;

    cp_async_wait<STAGES - 2>();   // this step's group has landed ...
    __syncthreads();               // ... for every thread; the slot staged
                                   // below was computed by all
    // each window's channel powers and weight
    for (int i = t; i < G * nC; i += THREADS) {
      const int wl = i / nC, c = i - wl * nC;
      const bool is_e = c < EB;
      const int cb = is_e ? EB : MB;
      const int cl = is_e ? c : c - EB;
      const float2* v = (is_e ? Es : Ms) + wl * K * cb + cl;
      float pw = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 x = v[k * cb];
        pw += x.x * x.x + x.y * x.y;
      }
      (is_e ? pes + wl * EB : pms + wl * MB)[cl] = pw;
    }
    const int win0 = grp * G;
    if (t < G) ws[t] = win0 + t < g.wc ? weights[win0 + t] : 0.f;
    if (step + STAGES - 1 < steps) stage(step + STAGES - 1);
    cp_async_commit();
    __syncthreads();               // powers and weights visible

    const int nwin = min(G, g.wc - win0);
#pragma unroll 1
    for (int i = 0; i < nwin; ++i) {
      const float w = ws[i];
      float2 ev[TE][K];
      float pev[TE];
#pragma unroll
      for (int a = 0; a < TE; ++a) {
        pev[a] = pes[i * EB + el0 + a];
#pragma unroll
        for (int k = 0; k < K; ++k)
          ev[a][k] = Es[((i * K + k) << log_eb) + el0 + a];
      }
#pragma unroll
      for (int b = 0; b < TM; ++b) {
        const int ml = lm + b * LM;
        float2 mv[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          mv[k] = Ms[((i * K + k) << log_mb) + ml];
        const float pmv = pms[i * MB + ml];
#pragma unroll
        for (int a = 0; a < TE; ++a) {
          const float den = nan_max(pev[a] * pmv, FLT_MIN);
          // sqrt(w / den) in IEEE arithmetic; where w is ±0 that is w
          // itself, or NaN where den is NaN (den >= FLT_MIN otherwise),
          // written without the division, whose slow path a zero
          // numerator takes
          const float sc = w == 0.f ? (den != den ? den : w)
                                    : sqrtf(w / den);
          float yr[K], yi[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float2 x = ev[a][k], y = mv[k];
            // conj(E)·M: re = er·mr + ei·mi, im = er·mi − ei·mr
            yr[k] = (x.x * y.x + x.y * y.y) * sc;
            yi[k] = (x.x * y.y - x.y * y.x) * sc;
            d[a][b] = fmaf(yi[k], yi[k], fmaf(yr[k], yr[k], d[a][b]));
          }
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int l = k + 1; l < K; ++l) {
              const int p = k * (2 * K - k - 1) / 2 + (l - k - 1);  // triu
              // each product into the sum by one FMA
              ar[a][b][p] = fmaf(yi[k], yi[l], fmaf(yr[k], yr[l],
                                                    ar[a][b][p]));
              ai[a][b][p] = fmaf(-yr[k], yi[l], fmaf(yi[k], yr[l],
                                                     ai[a][b][p]));
            }
        }
      }
    }

    if (grp == g.groups - 1) {     // the unit's last group: store, reset
      const size_t N = (size_t)g.E * g.M, FN = (size_t)g.F * N;
#pragma unroll
      for (int a = 0; a < TE; ++a)
#pragma unroll
        for (int b = 0; b < TM; ++b) {
          const int e = e0 + el0 + a, m = m0 + lm + b * LM;
          if (e < g.E && m < g.M) {
            const size_t o = (size_t)f * N + (size_t)e * g.M + m;
            if (g.accumulate) {
              // out + sum, one rounding each; the old sums are read
              // ACC_BATCH pairs at a time, in flight together
              d[a][b] = __fadd_rn(diag[o], d[a][b]);
#pragma unroll
              for (int p0 = 0; p0 < P2; p0 += ACC_BATCH) {
                float opr[ACC_BATCH], opi[ACC_BATCH];
#pragma unroll
                for (int j = 0; j < ACC_BATCH; ++j)
                  if (p0 + j < P2) {
                    opr[j] = pr[(p0 + j) * FN + o];
                    opi[j] = pi[(p0 + j) * FN + o];
                  }
#pragma unroll
                for (int j = 0; j < ACC_BATCH; ++j)
                  if (p0 + j < P2) {
                    ar[a][b][p0 + j] = __fadd_rn(opr[j], ar[a][b][p0 + j]);
                    ai[a][b][p0 + j] = __fadd_rn(opi[j], ai[a][b][p0 + j]);
                  }
              }
            }
            diag[o] = d[a][b];
#pragma unroll
            for (int p = 0; p < P2; ++p) {
              pr[p * FN + o] = ar[a][b][p];
              pi[p * FN + o] = ai[a][b][p];
            }
          }
          d[a][b] = 0.f;
#pragma unroll
          for (int p = 0; p < P2; ++p) ar[a][b][p] = ai[a][b][p] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
}

template <int K>
cudaError_t launch(const void* eeg, const void* emg, const void* weights,
                   void* diag, void* pr, void* pi, int wc, int F, int E,
                   int M, int accumulate, cudaStream_t stream) {
  constexpr int TE = Tile<K>::TE, TM = Tile<K>::TM;
  constexpr int WARPS = Tile<K>::WARPS, THREADS = 32 * WARPS;
  Geom g;
  g.wc = wc; g.F = F; g.E = E; g.M = M;
  // lanes along m: the fewest (from 4, which bounds the EEG rows a block
  // stages, and so its ring, at small M) that cover M, at most 32
  int LM = 4;
  while (LM < 32 && LM * TM < M) LM *= 2;
  g.log_lm = ilog2(LM);
  g.MB = LM * TM;
  g.EB = WARPS * (32 / LM) * TE;
  g.log_eb = ilog2(g.EB);
  g.log_mb = ilog2(g.MB);
  g.units_e = (E + g.EB - 1) / g.EB;
  g.units_m = (M + g.MB - 1) / g.MB;
  const long long units = (long long)F * g.units_e * g.units_m;
  // a chunk with no window still writes (or adds) its zero sums
  const long long groups = wc > 0 ? (wc + G - 1) / G : 1;
  if (units * groups > INT_MAX || (long long)wc * K * F > INT_MAX)
    return cudaErrorInvalidValue;
  g.n_units = (int)units;
  g.groups = (int)groups;
  g.slot_floats = slot_floats_of(K, g.EB, g.MB);
  g.vec = E % 2 == 0 && M % 2 == 0
      && reinterpret_cast<uintptr_t>(eeg) % 16 == 0
      && reinterpret_cast<uintptr_t>(emg) % 16 == 0;
  g.accumulate = accumulate != 0;

  auto kernel = LM == 32 ? coeff_pairs_kernel<K, TE, TM, true>
                         : coeff_pairs_kernel<K, TE, TM, false>;
  const int smem = STAGES * g.slot_floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(units < resident ? units : resident);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float2*>(eeg), static_cast<const float2*>(emg),
      static_cast<const float*>(weights), static_cast<float*>(diag),
      static_cast<float*>(pr), static_cast<float*>(pi), g);
  return cudaGetLastError();
}

// ---- any K: the runtime-K instance -------------------------------------

constexpr int RT_THREADS = 128;
constexpr int PAIR_BLOCK = 8;

__global__ void __launch_bounds__(RT_THREADS)
coeff_pairs_rt_kernel(const float2* __restrict__ eeg,
                      const float2* __restrict__ emg,
                      const float* __restrict__ weights,
                      float* __restrict__ diag, float* __restrict__ pr,
                      float* __restrict__ pi, int wc, int K, int F, int E,
                      int M, int accumulate) {
  const size_t N = (size_t)E * M, FN = (size_t)F * N;
  const size_t cell = (size_t)blockIdx.x * RT_THREADS + threadIdx.x;
  if (cell >= FN) return;
  const int f = (int)(cell / N);
  const int e = (int)((cell - (size_t)f * N) / M);
  const int m = (int)(cell - (size_t)f * N - (size_t)e * M);
  const int P2 = K * (K - 1) / 2;
  // taper k of window i: row i·K + k of the (wc·K, F, C) views
  auto E_at = [&](int i, int k) {
    return __ldg(eeg + (((size_t)i * K + k) * F + f) * E + e);
  };
  auto M_at = [&](int i, int k) {
    return __ldg(emg + (((size_t)i * K + k) * F + f) * M + m);
  };
  // window i's scale sqrt(w / max(pe·pm, FLT_MIN)), as the kernel above
  auto scale = [&](int i) {
    float pe = 0.f, pm = 0.f;
    for (int k = 0; k < K; ++k) {
      const float2 x = E_at(i, k), y = M_at(i, k);
      pe += x.x * x.x + x.y * x.y;
      pm += y.x * y.x + y.y * y.y;
    }
    const float w = weights[i];
    const float den = nan_max(pe * pm, FLT_MIN);
    return w == 0.f ? (den != den ? den : w) : sqrtf(w / den);
  };
  auto product = [&](int i, int k, float sc, float& yr, float& yi) {
    const float2 x = E_at(i, k), y = M_at(i, k);
    yr = (x.x * y.x + x.y * y.y) * sc;
    yi = (x.x * y.y - x.y * y.x) * sc;
  };

  float d = 0.f;
  for (int i = 0; i < wc; ++i) {
    const float sc = scale(i);
    for (int k = 0; k < K; ++k) {
      float yr, yi;
      product(i, k, sc, yr, yi);
      d = fmaf(yi, yi, fmaf(yr, yr, d));
    }
  }
  diag[cell] = accumulate ? __fadd_rn(diag[cell], d) : d;

  // pairs k < l in triu order, PAIR_BLOCK of them a pass
  int k0 = 0, l0 = 1;
  for (int p0 = 0; p0 < P2; p0 += PAIR_BLOCK) {
    int kk[PAIR_BLOCK], ll[PAIR_BLOCK];
    float ar[PAIR_BLOCK], ai[PAIR_BLOCK];
#pragma unroll
    for (int j = 0; j < PAIR_BLOCK; ++j) {
      kk[j] = k0;
      ll[j] = l0;
      ar[j] = ai[j] = 0.f;
      if (++l0 == K) l0 = ++k0 + 1;
    }
    const int np = P2 - p0 < PAIR_BLOCK ? P2 - p0 : PAIR_BLOCK;
    for (int i = 0; i < wc; ++i) {
      const float sc = scale(i);
#pragma unroll
      for (int j = 0; j < PAIR_BLOCK; ++j)
        if (j < np) {
          float yrk, yik, yrl, yil;
          product(i, kk[j], sc, yrk, yik);
          product(i, ll[j], sc, yrl, yil);
          ar[j] = fmaf(yik, yil, fmaf(yrk, yrl, ar[j]));
          ai[j] = fmaf(-yrk, yil, fmaf(yik, yrl, ai[j]));
        }
    }
#pragma unroll
    for (int j = 0; j < PAIR_BLOCK; ++j)
      if (j < np) {
        const size_t o = (size_t)(p0 + j) * FN + cell;
        pr[o] = accumulate ? __fadd_rn(pr[o], ar[j]) : ar[j];
        pi[o] = accumulate ? __fadd_rn(pi[o], ai[j]) : ai[j];
      }
  }
}

cudaError_t launch_rt(const void* eeg, const void* emg, const void* weights,
                      void* diag, void* pr, void* pi, int wc, int K, int F,
                      int E, int M, int accumulate, cudaStream_t stream) {
  const long long cells = (long long)F * E * M;
  const long long blocks = (cells + RT_THREADS - 1) / RT_THREADS;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  coeff_pairs_rt_kernel<<<(int)blocks, RT_THREADS, 0, stream>>>(
      static_cast<const float2*>(eeg), static_cast<const float2*>(emg),
      static_cast<const float*>(weights), static_cast<float*>(diag),
      static_cast<float*>(pr), static_cast<float*>(pi), wc, K, F, E, M,
      accumulate);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mba_coeff_pairs(const void* eeg, const void* emg,
                               const void* weights, void* diag, void* pr,
                               void* pi, int wc, int K, int F, int E, int M,
                               int accumulate, void* stream) {
  if (wc < 0 || F <= 0 || E <= 0 || M <= 0 || K < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MBA_CASE(k)                                                       \
  case k:                                                                 \
    return launch<k>(eeg, emg, weights, diag, pr, pi, wc, F, E, M,        \
                     accumulate, s);
  switch (K) {
    MBA_CASE(2) MBA_CASE(3) MBA_CASE(4) MBA_CASE(5) MBA_CASE(6) MBA_CASE(7)
    MBA_CASE(8) MBA_CASE(9) MBA_CASE(10) MBA_CASE(11) MBA_CASE(12)
    MBA_CASE(13) MBA_CASE(14) MBA_CASE(15) MBA_CASE(16)
    default:
      return (int)launch_rt(eeg, emg, weights, diag, pr, pi, wc, K, F, E, M,
                            accumulate, s);
  }
#undef MBA_CASE
}
