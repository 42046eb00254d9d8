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
// Above K = 16 the runtime-K instance (coeff_pairs_rt_kernel) takes any K.
// There the pair sums are the work: at K = 17 a cell-window is 17
// products y_k but 136 pairs, 1 296 flops.  They are the strict upper
// triangle of the K×K rank-wc update Σ_w y·yᴴ of each cell, cut into 4×4
// tiles that a warp holds in registers for 64 cells (a SYRK micro-kernel
// on the CUDA cores), with each y_k formed once into shared memory and
// read by the tiles of its row and column.  A tile's 64 sums a thread
// fit the 128 registers that 16 warps a block leave, without spills;
// fewer warps (more registers) take two passes over the windows at K =
// 17 and ran over half again as long (chip_probe.py coeff-split).  What
// bounds it on the H100: the FMAs of the tiles and the shared-memory
// reads of y (8 a 4×4 tile a window), then the bytes: 783 MB of sums at the main path's chunk (K =
// 17, F = 175, 64×64), read too in the accumulate form.  Its first form (a
// thread a cell, 8 pair sums a pass over the chunk, the spectra re-read
// from L1/L2 and the scale formed again each pass) took 14.985-15.102 ms
// there (NVIDIA H100 80GB HBM3, 700 W); this one is timed by
// chip_smoke.py and split by chip_probe.py
// coeff-split (PERF.md).  The compile-time instances stay faster at K =
// 12-16 (chip_probe.py coeff-dispatch), so the dispatch stays above 16.
//
// Numerics as the plain version's: no fast math.  The clamp is
// NaN-propagating, as jnp.maximum: a NaN spectrum gives NaN sums even in a
// zero-weight window, which is evaluated like any other.  IEEE division
// and sqrtf (a zero weight gives their exact result, ±0 or NaN, without
// the division; see the window loop); denormals are kept (no -ftz), so a
// denormal pe·pm clamps to FLT_MIN as on the CPU.  Sums run in window
// order, one thread a sum (the runtime-K diagonal adds its tiles' partial
// sums in block order): no atomics, deterministic.  The products are
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

// ---- any K: the runtime-K instance ----------------------------------
//
// A unit is (frequency, UE EEG × UM EMG cells), 64 cells, UM = the lanes
// along m (a power of two, up to 8): two lane groups of 32 cells, h = 0, 1.
// A cell's pair sums are the strict upper triangle of the K×K product
// Σ_w y·yᴴ, cut into RT_TB × RT_TB tiles (a, b), a <= b, of nb = ⌈K/4⌉
// blocks: in each pass over the unit's windows, warp w owns one tile for
// both lane groups, its sums in registers.  The windows come in groups of
// G; one barrier a group: while group s+2's spectra land (cp.async ring
// of three), the block forms group s+1's scales, and then, window by
// window, group s's products y (shared memory, double-buffered), each
// thread a few, and the tiles' sums of group s−1's: each warp alternates
// the two, so one's loads wait while the other's FMAs issue.  The channel
// powers pe, pm come from a first pass over the chunk
// (coeff_powers_kernel), each formed once, and are staged with the
// spectra.

constexpr int RT_TB = 4;          // tapers a tile side
constexpr int RT_CELLS = 64;      // cells a unit
constexpr int RT_MAX_WARPS = 16;  // tiles a pass
constexpr int RT_STAGES = 3;      // groups in the ring
constexpr int RT_LOCS = 6;        // steps whose place a block keeps

struct RtGeom {
  int wc, K, F, E, M;
  int log_lm, UE, UM, log_ue;     // unit: UE × UM cells, UM = 1 << log_lm
  int units_e, units_m, n_units;
  int nb, n_tiles, warps, passes, G, groups;
  int slot_floats;                // ring slot (rt_slot_floats)
  int vec, accumulate;
};

// floats of one ring slot: E [G·K][UE] and M [G·K][UM] (float2), then
// pe [G][UE], pm [G][UM] and w [G], rounded up to 16 bytes
__host__ __device__ constexpr int rt_slot_floats(int G, int K, int UE,
                                                 int UM) {
  return (2 * G * K * (UE + UM) + G * (UE + UM + 1) + 3) / 4 * 4;
}

// shared memory: the ring, the products y [2] (float2 [G·K][64]), the
// scales [2][G][64] and the diagonal's partial sums [2][nb][64]
__host__ __device__ constexpr int rt_smem_floats(int G, int K, int UE,
                                                 int UM, int nb) {
  return RT_STAGES * rt_slot_floats(G, K, UE, UM)
      + 2 * 2 * G * K * RT_CELLS + 2 * G * RT_CELLS + 2 * nb * RT_CELLS;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// Rows row0 .. row0 + rows of the (wc·K, F, C) view (window row / K,
// taper row % K) at frequency f, channels c0 .. c0 + 2^log_cb, into
// dst[r][2^log_cb]; zero past row_end (= wc·K) and past C
__device__ __forceinline__ void copy_rows_rt(float2* dst, const float2* src,
                                             int C, int c0, int log_cb,
                                             int f, int F, int row0,
                                             int rows, int row_end, bool vec,
                                             int t, int n_threads) {
  const int per = vec ? 2 : 1;
  const int log_q = log_cb - (vec ? 1 : 0);
  const int items = rows << log_q;
  for (int i = t; i < items; i += n_threads) {
    const int r = i >> log_q;
    const int c = (i & ((1 << log_q) - 1)) * per;
    const int row = row0 + r;
    const bool ok = row < row_end && c0 + c < C;
    const float2* s = ok ? src + ((size_t)row * F + f) * C + c0 + c : src;
    cp_async(dst + (r << log_cb) + c, s, 8 * per, ok ? 8 * per : 0);
  }
}

// The first pass: each window's channel powers Σ_k |x_k|², in the
// compile-time kernel's operations, for the EEG (wc, F, E) and then the
// EMG (wc, F, M) channels: a thread a (window, frequency, channel)
__global__ void __launch_bounds__(256)
coeff_powers_kernel(const float2* __restrict__ eeg,
                    const float2* __restrict__ emg, float* __restrict__ pe,
                    float* __restrict__ pm, int wc, int K, int F, int E,
                    int M) {
  const long long ne = (long long)wc * F * E, n = ne + (long long)wc * F * M;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const bool is_e = i < ne;
    const long long j = is_e ? i : i - ne;
    const int C = is_e ? E : M;
    const long long FC = (long long)F * C;
    const long long w = j / FC, rest = j - w * FC;   // rest = f·C + c
    const float2* x = (is_e ? eeg : emg) + w * K * FC + rest;
    float pw = 0.f;
    for (int k = 0; k < K; ++k) {
      const float2 v = x[k * FC];
      pw += v.x * v.x + v.y * v.y;
    }
    (is_e ? pe : pm)[j] = pw;
  }
}

// One window's products yw (yw[k·64] = y_k of this lane's cell) into an
// off-diagonal tile: 4 rows k0.. × RB columns l0.. of pairs, for both lane
// groups, every product added by one FMA (the compile-time kernel's form)
template <int RB>
__device__ __forceinline__ void rt_tile_off(float (&ar)[2][RT_TB][RT_TB],
                                            float (&ai)[2][RT_TB][RT_TB],
                                            const float2* yw, int k0,
                                            int l0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2 yk[RT_TB], yl[RB];
#pragma unroll
    for (int a = 0; a < RT_TB; ++a) yk[a] = yw[(k0 + a) * RT_CELLS + 32 * h];
#pragma unroll
    for (int b = 0; b < RB; ++b) yl[b] = yw[(l0 + b) * RT_CELLS + 32 * h];
#pragma unroll
    for (int a = 0; a < RT_TB; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        ar[h][a][b] = fmaf(yk[a].y, yl[b].y,
                           fmaf(yk[a].x, yl[b].x, ar[h][a][b]));
        ai[h][a][b] = fmaf(-yk[a].x, yl[b].y,
                           fmaf(yk[a].y, yl[b].x, ai[h][a][b]));
      }
  }
}

// One window into a diagonal tile: its RA tapers k0.., the pairs a < b
// among them and the diagonal's partial sum Σ |y_k|² over them
template <int RA>
__device__ __forceinline__ void rt_tile_diag(float (&ar)[2][RT_TB][RT_TB],
                                             float (&ai)[2][RT_TB][RT_TB],
                                             float (&dd)[2],
                                             const float2* yw, int k0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2 yk[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) yk[a] = yw[(k0 + a) * RT_CELLS + 32 * h];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      dd[h] = fmaf(yk[a].y, yk[a].y, fmaf(yk[a].x, yk[a].x, dd[h]));
#pragma unroll
      for (int b = a + 1; b < RA; ++b) {
        ar[h][a][b] = fmaf(yk[a].y, yk[b].y,
                           fmaf(yk[a].x, yk[b].x, ar[h][a][b]));
        ai[h][a][b] = fmaf(-yk[a].x, yk[b].y,
                           fmaf(yk[a].y, yk[b].x, ai[h][a][b]));
      }
    }
  }
}

// A tile's sums out (added to what the outputs hold with `accumulate`:
// out + sum, one rounding), then zeroed.  Lanes run along the cells, so
// a warp's stores to one pair's plane are consecutive along m.
template <int RA, int RB, bool DIAG>
__device__ __forceinline__ void rt_tile_store(float (&ar)[2][RT_TB][RT_TB],
                                              float (&ai)[2][RT_TB][RT_TB],
                                              float* __restrict__ pr,
                                              float* __restrict__ pi,
                                              const size_t (&o)[2],
                                              const bool (&ok)[2], int k0,
                                              int l0, int K, size_t FN,
                                              bool accumulate) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int k = k0 + a;
      const size_t row = (size_t)(k * (2 * K - k - 1) / 2) * FN + o[h];
      float opr[RB], opi[RB];
      if (ok[h] && accumulate) {
        // the old sums of the row read together, in flight at once
#pragma unroll
        for (int b = DIAG ? a + 1 : 0; b < RB; ++b) {
          const size_t q = row + (size_t)(l0 + b - k - 1) * FN;
          opr[b] = pr[q];
          opi[b] = pi[q];
        }
      }
#pragma unroll
      for (int b = DIAG ? a + 1 : 0; b < RB; ++b) {
        if (ok[h]) {
          const size_t q = row + (size_t)(l0 + b - k - 1) * FN;
          // streaming stores: nothing reads the sums again in this launch
          __stcs(pr + q, accumulate ? __fadd_rn(opr[b], ar[h][a][b])
                                    : ar[h][a][b]);
          __stcs(pi + q, accumulate ? __fadd_rn(opi[b], ai[h][a][b])
                                    : ai[h][a][b]);
        }
        ar[h][a][b] = ai[h][a][b] = 0.f;
      }
    }
  }
}

// The old sums a tile's store will read in the accumulate form, asked of
// L2 before its pass's last group is added, so that the store's loads do
// not wait on device memory
template <int RA, int RB, bool DIAG>
__device__ __forceinline__ void rt_tile_prefetch(const float* pr,
                                                 const float* pi,
                                                 const size_t (&o)[2],
                                                 const bool (&ok)[2], int k0,
                                                 int l0, int K, size_t FN) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int k = k0 + a;
      const size_t row = (size_t)(k * (2 * K - k - 1) / 2) * FN + o[h];
#pragma unroll
      for (int b = DIAG ? a + 1 : 0; b < RB; ++b) {
        const size_t q = row + (size_t)(l0 + b - k - 1) * FN;
        asm volatile("prefetch.global.L2 [%0];" ::"l"(pr + q));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(pi + q));
      }
    }
  }
}

// tile index t of the upper triangle of nb blocks, row-major → (a, b)
__device__ __forceinline__ void rt_tile(int t, int nb, int& a, int& b) {
  a = 0;
  while (t >= nb - a) {
    t -= nb - a;
    ++a;
  }
  b = a + t;
}

__global__ void __launch_bounds__(32 * RT_MAX_WARPS, 1)
coeff_pairs_rt_kernel(const float2* __restrict__ eeg,
                      const float2* __restrict__ emg,
                      const float* __restrict__ weights,
                      const float* __restrict__ pe,
                      const float* __restrict__ pm,
                      float* __restrict__ diag, float* __restrict__ pr,
                      float* __restrict__ pi, const RtGeom g) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int K = g.K, G = g.G, UE = g.UE, UM = g.UM;
  const int t = threadIdx.x, n_threads = blockDim.x;
  const int warp = t >> 5, lane = t & 31;
  // shared memory (rt_smem_floats); a slot: E, M rows, pe, pm, w
  float* const ring = smem;
  float2* const ybuf =
      reinterpret_cast<float2*>(ring + RT_STAGES * g.slot_floats);
  float* const scb = reinterpret_cast<float*>(ybuf + 2 * G * K * RT_CELLS);
  float* const dpart = scb + 2 * G * RT_CELLS;
  const int off_m = 2 * G * K * UE;
  const int off_pe = off_m + 2 * G * K * UM;
  const int off_pm = off_pe + G * UE;
  const int off_w = off_pm + G * UM;
  const int ych = G * K * RT_CELLS;          // float2s of one y buffer

  const size_t N = (size_t)g.E * g.M, FN = (size_t)g.F * N;
  const int my_units = (int)blockIdx.x < g.n_units
      ? (g.n_units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = my_units * g.passes * g.groups;
  const int per_f = g.units_e * g.units_m;
  // a step's place: this block's unit i, its (f, e0, m0), pass and group.
  // Thread 0 walks the block's steps in order, a division only where a
  // unit starts, and keeps the places of RT_LOCS steps in shared memory:
  // an iteration reads steps it−2 .. it+2 and writes step it+3.  The walk
  // lies in shared memory too: in registers, every thread would hold it,
  // and ptxas would spill beside the tiles' sums at 128 registers
  struct Loc {
    int i, f, e0, m0, pass, grp;
  };
  __shared__ Loc locs[RT_LOCS];
  __shared__ Loc walk;
  if (t == 0) walk = Loc{0, 0, 0, 0, 0, 0};
  auto put = [&](int step) {
    if (t != 0 || step >= steps) return;
    if (walk.pass == 0 && walk.grp == 0) {
      const int u = blockIdx.x + walk.i * gridDim.x;
      walk.f = u / per_f;
      const int r = u - walk.f * per_f;
      const int ue = r / g.units_m;
      walk.e0 = ue * UE;
      walk.m0 = (r - ue * g.units_m) * UM;
    }
    locs[step % RT_LOCS] = walk;
    if (++walk.grp == g.groups) {
      walk.grp = 0;
      if (++walk.pass == g.passes) {
        walk.pass = 0;
        ++walk.i;
      }
    }
  };
  auto locate = [&](int step) { return locs[step % RT_LOCS]; };
  auto slot_of = [&](int step) {
    return ring + (step % RT_STAGES) * g.slot_floats;
  };
  auto windows = [&](const Loc& l) {
    return max(0, min(G, g.wc - l.grp * G));
  };
  // a group's spectra, channel powers and weights, copied by every thread
  auto stage = [&](int step) {
    if (step < steps) {
      const Loc l = locate(step);
      float* slot = slot_of(step);
      const int win0 = l.grp * G;
      copy_rows_rt(reinterpret_cast<float2*>(slot), eeg, g.E, l.e0,
                   g.log_ue, l.f, g.F, win0 * K, G * K, g.wc * K, g.vec, t,
                   n_threads);
      copy_rows_rt(reinterpret_cast<float2*>(slot + off_m), emg, g.M, l.m0,
                   g.log_lm, l.f, g.F, win0 * K, G * K, g.wc * K, g.vec, t,
                   n_threads);
      for (int i = t; i < G * (UE + UM + 1); i += n_threads) {
        const int wl = i / (UE + UM + 1), c = i - wl * (UE + UM + 1);
        const int win = win0 + wl;
        bool ok = win < g.wc;
        const float* src = weights + (ok ? win : 0);
        float* dst = slot + off_w + wl;
        if (c < UE) {
          ok = ok && l.e0 + c < g.E;
          src = ok ? pe + ((size_t)win * g.F + l.f) * g.E + l.e0 + c : pe;
          dst = slot + off_pe + wl * UE + c;
        } else if (c < UE + UM) {
          ok = ok && l.m0 + c - UE < g.M;
          src = ok ? pm + ((size_t)win * g.F + l.f) * g.M + l.m0 + c - UE
                   : pm;
          dst = slot + off_pm + wl * UM + c - UE;
        }
        cp_async4(dst, src, ok);
      }
    }
    cp_async_commit();
  };
  // a group's scales sqrt(w / max(pe·pm, FLT_MIN)), a thread a
  // cell-window, in IEEE arithmetic; where w is ±0 the scale is w itself,
  // or NaN where the denominator is NaN (as the compile-time kernel)
  auto scales = [&](int step) {
    const Loc l = locate(step);
    const float* slot = slot_of(step);
    float* sc = scb + (step & 1) * G * RT_CELLS;
    for (int icw = t; icw < windows(l) * RT_CELLS; icw += n_threads) {
      const int i = icw >> 6, c = icw & (RT_CELLS - 1);
      const float w = slot[off_w + i];
      const float den = nan_max(slot[off_pe + i * UE + (c >> g.log_lm)]
                                    * slot[off_pm + i * UM + (c & (UM - 1))],
                                FLT_MIN);
      sc[icw] = w == 0.f ? (den != den ? den : w) : sqrtf(w / den);
    }
  };

  float ar[2][RT_TB][RT_TB], ai[2][RT_TB][RT_TB], dd[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int a = 0; a < RT_TB; ++a)
#pragma unroll
      for (int b = 0; b < RT_TB; ++b) ar[h][a][b] = ai[h][a][b] = 0.f;

  // this thread's two cells in a unit: c = 32·h + lane
  int el[2], ml[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    el[h] = (32 * h + lane) >> g.log_lm;
    ml[h] = (32 * h + lane) & (UM - 1);
  }

  // prologue: the places of steps 0-2, groups 0 and 1 in flight, group
  // 0's scales
  put(0);
  put(1);
  put(2);
  __syncthreads();
  stage(0);
  stage(1);
  cp_async_wait<1>();
  __syncthreads();
  if (steps > 0) scales(0);

  int pending = -1;                  // a unit whose diagonal is to be summed
  for (int it = 0; it <= steps; ++it) {
    cp_async_wait<0>();              // groups it and it+1 have landed ...
    __syncthreads();                 // ... for every thread, with group
                                     // it's scales and group it−1's y
    if (pending >= 0) {
      // the diagonal of the unit that ended last group: its partial sums
      // (one a diagonal tile) added in block order
      const Loc l = locate(pending);
      const float* dp = dpart + (l.i & 1) * g.nb * RT_CELLS;
      if (t < RT_CELLS) {
        const int e = l.e0 + (t >> g.log_lm), m = l.m0 + (t & (UM - 1));
        if (e < g.E && m < g.M) {
          float d = dp[t];
          for (int q = 1; q < g.nb; ++q) d += dp[q * RT_CELLS + t];
          const size_t od = (size_t)l.f * N + (size_t)e * g.M + m;
          diag[od] = g.accumulate ? __fadd_rn(diag[od], d) : d;
        }
      }
      pending = -1;
    }
    put(it + 3);
    stage(it + 2);
    if (it + 1 < steps) scales(it + 1);
    // group it's products (np windows) and group it−1's tile sums (na
    // windows), window by window
    // (the pointers are set at it == steps too, where no window reads
    // them)
    const int np = it < steps ? windows(locate(it)) : 0;
    int na = 0;
    const float2* const Es = reinterpret_cast<const float2*>(slot_of(it));
    const float2* const Ms =
        reinterpret_cast<const float2*>(slot_of(it) + off_m);
    const float* const sc = scb + (it & 1) * G * RT_CELLS;
    float2* const yp = ybuf + (it & 1) * ych;
    Loc l = {0, 0, 0, 0, 0, 0};
    int tile = g.n_tiles, a = 0, b = 0;
    const float2* ya = ybuf + ((it + 1) & 1) * ych + lane;   // group it−1
    if (it > 0) {
      l = locate(it - 1);
      na = windows(l);
      tile = l.pass * g.warps + warp;
      if (tile < g.n_tiles) rt_tile(tile, g.nb, a, b);
    }
    const int k0 = RT_TB * a, l0 = RT_TB * b;
    const int RA = min(RT_TB, K - k0), RB = min(RT_TB, K - l0);
    // window i's K·64 products y_k, a few a thread, cells along lanes
    auto products = [&](int i) {
      for (int q = t; q < K * RT_CELLS; q += n_threads) {
        const int k = q >> 6, c = q & (RT_CELLS - 1);
        const float2 x = Es[(i * K + k) * UE + (c >> g.log_lm)];
        const float2 v = Ms[(i * K + k) * UM + (c & (UM - 1))];
        const float s = sc[i * RT_CELLS + c];
        yp[(i * K + k) * RT_CELLS + c] =
            make_float2((x.x * v.x + x.y * v.y) * s,
                        (x.x * v.y - x.y * v.x) * s);
      }
    };
    auto sums = [&](int i) {
      const float2* yw = ya + i * K * RT_CELLS;
      if (a == b) {
        switch (RA) {
          case 1: rt_tile_diag<1>(ar, ai, dd, yw, k0); break;
          case 2: rt_tile_diag<2>(ar, ai, dd, yw, k0); break;
          case 3: rt_tile_diag<3>(ar, ai, dd, yw, k0); break;
          default: rt_tile_diag<4>(ar, ai, dd, yw, k0); break;
        }
      } else {
        switch (RB) {
          case 1: rt_tile_off<1>(ar, ai, yw, k0, l0); break;
          case 2: rt_tile_off<2>(ar, ai, yw, k0, l0); break;
          case 3: rt_tile_off<3>(ar, ai, yw, k0, l0); break;
          default: rt_tile_off<4>(ar, ai, yw, k0, l0); break;
        }
      }
    };
    // group it−1 ends its pass: in the accumulate form, the tile's old
    // sums asked of L2 before its last windows
    size_t o[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = l.e0 + el[h], m = l.m0 + ml[h];
      ok[h] = e < g.E && m < g.M;
      o[h] = (size_t)l.f * N + (size_t)e * g.M + m;
    }
    if (it > 0 && g.accumulate && l.grp == g.groups - 1
        && tile < g.n_tiles) {
      if (a == b) {
        switch (RA) {
          case 1: break;
          case 2: rt_tile_prefetch<2, 2, true>(pr, pi, o, ok, k0, l0, K, FN);
                  break;
          case 3: rt_tile_prefetch<3, 3, true>(pr, pi, o, ok, k0, l0, K, FN);
                  break;
          default: rt_tile_prefetch<4, 4, true>(pr, pi, o, ok, k0, l0, K,
                                                FN); break;
        }
      } else {
        switch (RB) {
          case 1: rt_tile_prefetch<4, 1, false>(pr, pi, o, ok, k0, l0, K,
                                                FN); break;
          case 2: rt_tile_prefetch<4, 2, false>(pr, pi, o, ok, k0, l0, K,
                                                FN); break;
          case 3: rt_tile_prefetch<4, 3, false>(pr, pi, o, ok, k0, l0, K,
                                                FN); break;
          default: rt_tile_prefetch<4, 4, false>(pr, pi, o, ok, k0, l0, K,
                                                 FN); break;
        }
      }
    }
    // window by window: a warp's product loads wait while other warps'
    // FMAs issue
    for (int i = 0; i < G; ++i) {
      if (i < np) products(i);
      if (i < na && tile < g.n_tiles) sums(i);
    }
    if (it == 0 || l.grp != g.groups - 1) continue;
    // group it−1 ended its pass: store the tile's pairs, keep the
    // diagonal's partial sums for the unit's end
    if (tile < g.n_tiles) {
      if (a == b) {
        float* dp = dpart + (l.i & 1) * g.nb * RT_CELLS;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dp[a * RT_CELLS + 32 * h + lane] = dd[h];
          dd[h] = 0.f;
        }
        switch (RA) {
          case 1: break;      // one taper: no pair
          case 2: rt_tile_store<2, 2, true>(ar, ai, pr, pi, o, ok, k0, l0, K,
                                            FN, g.accumulate); break;
          case 3: rt_tile_store<3, 3, true>(ar, ai, pr, pi, o, ok, k0, l0, K,
                                            FN, g.accumulate); break;
          default: rt_tile_store<4, 4, true>(ar, ai, pr, pi, o, ok, k0, l0,
                                             K, FN, g.accumulate); break;
        }
      } else {
        switch (RB) {
          case 1: rt_tile_store<4, 1, false>(ar, ai, pr, pi, o, ok, k0, l0,
                                             K, FN, g.accumulate); break;
          case 2: rt_tile_store<4, 2, false>(ar, ai, pr, pi, o, ok, k0, l0,
                                             K, FN, g.accumulate); break;
          case 3: rt_tile_store<4, 3, false>(ar, ai, pr, pi, o, ok, k0, l0,
                                             K, FN, g.accumulate); break;
          default: rt_tile_store<4, 4, false>(ar, ai, pr, pi, o, ok, k0, l0,
                                              K, FN, g.accumulate); break;
        }
      }
    }
    if (l.pass == g.passes - 1) pending = it - 1;  // summed after the barrier
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pending >= 0 && t < RT_CELLS) {
    const Loc l = locate(pending);
    const float* dp = dpart + (l.i & 1) * g.nb * RT_CELLS;
    const int e = l.e0 + (t >> g.log_lm), m = l.m0 + (t & (UM - 1));
    if (e < g.E && m < g.M) {
      float d = dp[t];
      for (int q = 1; q < g.nb; ++q) d += dp[q * RT_CELLS + t];
      const size_t od = (size_t)l.f * N + (size_t)e * g.M + m;
      diag[od] = g.accumulate ? __fadd_rn(diag[od], d) : d;
    }
  }
}

// The unit shape, the tiles and the window group for K tapers; false
// where even one window a group does not fit the shared memory
bool rt_geometry(RtGeom& g, int smem_max) {
  // lanes along m: the fewest that cover M, at most 8, so that a unit of
  // 64 cells stages 8 + 8 channels (at M >= 8), the fewest rows for its
  // cells
  int LM = 1;
  while (LM < 8 && LM < g.M) LM *= 2;
  g.log_lm = ilog2(LM);
  g.UM = LM;
  g.UE = RT_CELLS / LM;
  g.log_ue = ilog2(g.UE);
  g.units_e = (g.E + g.UE - 1) / g.UE;
  g.units_m = (g.M + g.UM - 1) / g.UM;
  g.nb = (g.K + RT_TB - 1) / RT_TB;
  g.n_tiles = g.nb * (g.nb + 1) / 2;
  g.warps = g.n_tiles < RT_MAX_WARPS ? g.n_tiles : RT_MAX_WARPS;
  g.passes = (g.n_tiles + g.warps - 1) / g.warps;
  for (g.G = 8; g.G >= 1; g.G /= 2)
    if ((long long)rt_smem_floats(g.G, g.K, g.UE, g.UM, g.nb) * 4
        <= smem_max)
      break;
  if (g.G < 1) return false;
  g.slot_floats = rt_slot_floats(g.G, g.K, g.UE, g.UM);
  return true;
}

// The first pass into `scratch` (pe: wc·F·E floats, then pm: wc·F·M),
// then the pair pass
cudaError_t launch_rt(const void* eeg, const void* emg, const void* weights,
                      void* diag, void* pr, void* pi, void* scratch, int wc,
                      int K, int F, int E, int M, int accumulate,
                      cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  RtGeom g;
  g.wc = wc; g.K = K; g.F = F; g.E = E; g.M = M;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (!rt_geometry(g, smem_max)) return cudaErrorInvalidValue;
  const long long units = (long long)F * g.units_e * g.units_m;
  // a chunk with no window still writes (or adds) its zero sums
  const long long groups = wc > 0 ? (wc + g.G - 1) / g.G : 1;
  if (units * groups * g.passes > INT_MAX || (long long)wc * K * F > INT_MAX)
    return cudaErrorInvalidValue;
  g.n_units = (int)units;
  g.groups = (int)groups;
  g.vec = E % 2 == 0 && M % 2 == 0 && g.UM >= 2
      && reinterpret_cast<uintptr_t>(eeg) % 16 == 0
      && reinterpret_cast<uintptr_t>(emg) % 16 == 0;
  g.accumulate = accumulate != 0;
  float* pe = static_cast<float*>(scratch);
  float* pm = pe + (size_t)wc * F * E;
  const long long n_pow = (long long)wc * F * (E + M);
  if (n_pow > 0) {
    const long long blocks = (n_pow + 255) / 256;
    coeff_powers_kernel<<<(int)(blocks < 8 * sms ? blocks : 8 * sms), 256, 0,
                          stream>>>(static_cast<const float2*>(eeg),
                                    static_cast<const float2*>(emg), pe, pm,
                                    wc, K, F, E, M);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int threads = 32 * g.warps;
  const int smem = rt_smem_floats(g.G, K, g.UE, g.UM, g.nb) * 4;
  auto kernel = coeff_pairs_rt_kernel;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(units < resident ? units : resident);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const float2*>(eeg), static_cast<const float2*>(emg),
      static_cast<const float*>(weights), pe, pm, static_cast<float*>(diag),
      static_cast<float*>(pr), static_cast<float*>(pi), g);
  return cudaGetLastError();
}

bool valid(int wc, int K, int F, int E, int M) {
  return wc >= 0 && F > 0 && E > 0 && M > 0 && K >= 2;
}

}  // namespace

extern "C" int mba_coeff_pairs(const void* eeg, const void* emg,
                               const void* weights, void* diag, void* pr,
                               void* pi, void* scratch, int wc, int K, int F,
                               int E, int M, int accumulate, void* stream) {
  if (!valid(wc, K, F, E, M)) return (int)cudaErrorInvalidValue;
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
      return (int)launch_rt(eeg, emg, weights, diag, pr, pi, scratch, wc, K,
                            F, E, M, accumulate, s);
  }
#undef MBA_CASE
}

// The runtime-K instance at any K >= 2, also where a compile-time
// instance exists: for timing and holding the two against each other
extern "C" int mba_coeff_pairs_rt(const void* eeg, const void* emg,
                                  const void* weights, void* diag, void* pr,
                                  void* pi, void* scratch, int wc, int K,
                                  int F, int E, int M, int accumulate,
                                  void* stream) {
  if (!valid(wc, K, F, E, M)) return (int)cudaErrorInvalidValue;
  return (int)launch_rt(eeg, emg, weights, diag, pr, pi, scratch, wc, K, F,
                        E, M, accumulate, static_cast<cudaStream_t>(stream));
}
