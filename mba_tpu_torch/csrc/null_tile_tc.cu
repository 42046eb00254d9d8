// Kernel B2, 16-bit instances: the rotation-null surrogate tile on
// Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel mba_tpu/ops/pallas_null.py:_null_tile_kernel
// (:37-76) where the null's compute_dtype is bfloat16 or float16, as the
// JAX package picks on its TPU (cohort_null.py:1022-1025); the float32
// instance is csrc/null_tile.cu.  Per frequency f it evaluates
//     stat[s, n] = base[f, n] + (Gᵀ[f] · coefT[f])[s, n] · (1/J)
// with G (nF, JP, ldg) and coefT (nF, JP, ldc) 16-bit, each rounded once by
// the wrapper (cuda_null.null_features, prepare_null_coeffs), and reduces
// it in the epilogue: per cell n < N the count of real surrogates s < S
// with stat >= obs[f, n], and per surrogate the max over all (f, n),
// NaN-propagating.  The (F, S, N) statistic never reaches device memory.
//
// What bounds it on the H100: operations on the bf16/f16 tensor cores.
// The main path's chunk (nF 175, S 500, J·P 240, N 4096) is 1.720e11 flop:
// 0.174 ms at 989 TFLOP/s, against 0.39 GB read once (0.116 ms at 3.35
// TB/s).  A product of two 16-bit values is exact in float32 and the
// sums are float32 (wgmma's f32 accumulator), so this computes what the
// plain version (bmm of the operands widened to float32) computes, up to
// the order of the sums.
//
// The design:
// * Products: wgmma.mma_async m64n256k16, float32 accumulators, both
//   operands from shared memory.  G and coefT have the contraction axis
//   as rows (A M-major, B N-major), which wgmma takes through its
//   transpose bits, so nothing is relaid out.
// * Staging: TMA copies 64 × 64 boxes (128-byte rows, 128-byte swizzle)
//   into mbarrier rings: one of coefT slices (32 KB: 256 cells × 64 J·P
//   rows) and one of G slices for each consumer warpgroup (8 KB: its 64
//   surrogates × 64 rows).  A producer warpgroup (40 registers a thread,
//   setmaxnreg) issues them, one thread a ring, so no ring waits on
//   another; the two consumer warpgroups (232 registers: the 128
//   accumulators and the epilogue fit without spilling) issue the
//   wgmmas.  3-D tensor maps (row, J·P, frequency) fill zeros past S,
//   J·P and N, so the ragged edges need no code and a slice never reads
//   the next frequency.
// * Persistent blocks, one an SM: a work unit is (frequency, 256-cell
//   tile), and within it the block walks the 128-surrogate tiles.  Where
//   J·P fits the coefT ring (J·P <= 256, the main path's 240 is four
//   slices) the unit's coefT slices are loaded once and stay while G
//   streams, so each coefT byte crosses from L2 once; above that both
//   stream.  Consumers free each slice as soon as its wgmmas are done,
//   so the next tile's slices load during this tile's later products
//   and its epilogue.
// * The two consumer warpgroups take turns on the tensor cores: each
//   issues a tile's wgmmas only after the other has issued its own, so
//   one warpgroup's epilogue runs on the CUDA cores while the other's
//   products run.  The turns are mbarriers, which count arrivals
//   explicitly: named barriers (bar.sync/bar.arrive with a thread count)
//   let both warpgroups through at once here, as if the producer's
//   exited threads had arrived.  Each warpgroup keeps its own base, obs
//   and counts in shared memory, so the turns run on across units.  They
//   need the unit's coefT resident: streamed, warpgroup 0 would wait for
//   ring slots that only warpgroup 1's turn frees.
// * Epilogue on the accumulator layout (warp w of a warpgroup owns rows
//   16w..16w+15; lane l holds rows l/4 and l/4 + 8 at column pairs
//   2·(l%4) + 8i): the statistic rounded as the plain version rounds
//   it, __fadd_rn(base, __fmul_rn(acc, 1/J)); cells past N read base
//   -inf and obs +inf, so they neither count nor win a max.  Row maxima
//   by max.NaN over the lane's cells, then over the quad by shuffles: a
//   warp holds whole rows, so one partial a row per (frequency, cell
//   tile), reduced by the second kernel (csrc/null_tile.cu), with no
//   float atomics.  Counts: per lane 8-bit fields packed four to a
//   word, a compare and a predicated add a cell (the warps whose rows
//   are all real surrogates skip the row mask), summed over the 8 row
//   lanes by a reduce-scatter of shuffles (14 a lane), added per column
//   in shared memory (the column-to-lane map keeps the 32 lanes on 32
//   banks), then per unit into the cell's count by one integer atomic a
//   warpgroup (exact in any order).
// * 384 threads (two consumer warpgroups, one producer warpgroup),
//   ~200 KB of shared memory, one block an SM.
//
// Where the time goes: chip_probe.py null-tile-split times edited forms
// of this source (without the epilogue, the tensor cores alone, without
// the turns; PERF.md §6 holds the numbers).  The epilogue, one warp a
// scheduler, slows the other warpgroup's products beside it and bounds
// the kernel more than the tensor cores' rate does; branches in it cost
// more than the work they skip, so the count atomics add zeros and every
// thread arrives on the rings' barriers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// the per-surrogate max over the partial rows (csrc/null_tile.cu)
extern "C" int mba_null_reduce_max(const void* partial, void* max_out,
                                   int nT, int S, void* stream);

namespace {

constexpr int BM = 128;                 // surrogates per tile
constexpr int BN = 256;                 // cells per unit: one wgmma N
constexpr int BK = 64;                  // J·P rows a slice: 128-byte rows
constexpr int BOX = 64;                 // values along a TMA box's row
constexpr int BOX_BYTES = BOX * BK * 2;           // 8 KB
constexpr int B_SLICE = BN / BOX * BOX_BYTES;     // 32 KB
constexpr int A_STAGES = 4;             // G slices in each warpgroup's ring
constexpr int B_STAGES = 4;             // coefT slices in the ring
constexpr int K_STEP = 16;              // J·P rows a wgmma
constexpr int IN_FLIGHT = 1;            // slices still multiplying while
                                        // the next issues (2: no faster)
constexpr int WG = 128;                 // threads a warpgroup
constexpr int CONSUMERS = 2 * WG;
constexpr int THREADS = CONSUMERS + WG; // and the producer warpgroup
constexpr unsigned FULL = 0xffffffffu;

struct alignas(1024) Shared {           // 1024: the 128-byte swizzle atom
  uint8_t b[B_STAGES][B_SLICE];
  uint8_t a[2][A_STAGES][BOX_BYTES];    // per consumer warpgroup
  float base[2][BN];                    // per consumer warpgroup
  float obs[2][BN];
  int cnt[2][BN];
  uint64_t full_a[2][A_STAGES], empty_a[2][A_STAGES];
  uint64_t full_b[B_STAGES], empty_b[B_STAGES];
  // warpgroup g's turn on the tensor cores (the other's threads arrive),
  // and a barrier of warpgroup g alone (its own threads)
  uint64_t turn[2], wg[2];
};
constexpr size_t SMEM_BYTES = sizeof(Shared) + 1024;   // + alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of this parity.  A
// phase that never completes (a fault in the ring) traps after 4 s
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0) t0 = now;
    else if (now - t0 > 4000000000ull) __trap();
  }
}

// one box of a 3-D tensor map → shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of an M- or N-major operand in the
// 128-byte swizzle: core blocks of 64 values × 8 J·P rows (1024 bytes);
// the leading offset steps to the next 64 values (the next TMA box, 8 KB
// on), the stride offset to the next 8 rows (1 KB on).
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(BOX_BYTES >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC_REGS                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127"
// d (+)= A · B for one 64 × 256 × 16 step, A and B transposed (M- and
// N-major); scale_d 0 overwrites d
#define WGMMA_M64N256K16(TYPE)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPE "." TYPE " {"     \
      ACC_REGS "}, %128, %129, p, 1, 1, 1, 1;\n}\n"                         \
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), \
        ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96),         \
        ACC8(104), ACC8(112), ACC8(120)                                     \
      : "l"(da), "l"(db), "r"(scale_d))

template <bool F16>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (F16) WGMMA_M64N256K16("f16");
  else WGMMA_M64N256K16("bf16");
}

__device__ __forceinline__ float max_nan(float a, float b) {
  // jnp.max semantics: a NaN anywhere gives NaN
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// warpgroup-wide barrier on ``bar`` (count: the warpgroup's threads);
// ``phase`` counts its uses by this thread
__device__ __forceinline__ void wg_sync(uint64_t* bar, uint32_t& phase) {
  mbar_arrive(bar);
  mbar_wait(bar, phase & 1);
  ++phase;
}

// w += one where v >= o: a compare and a predicated add (the compiler
// would build the sums of two compares from selects)
__device__ __forceinline__ void count_ge(uint32_t& w, float v, float o,
                                         uint32_t one) {
  asm("{\n.reg .pred p;\nsetp.ge.f32 p, %1, %2;\n@p add.u32 %0, %0, %3;\n}"
      : "+r"(w)
      : "f"(v), "f"(o), "r"(one));
}

// Per-tile epilogue of one consumer thread: rows r0 and r0 + 8 of the
// block's surrogate tile, columns 8j + 2q + e (j < 32, e < 2) of the
// unit's 256 cells; base, obs and cnt are its warpgroup's.  ALL: every
// row of the thread's warp is a real surrogate (r0 + 8 < S for all its
// lanes), so no compare needs the row mask.
template <bool ALL>
__device__ __forceinline__ void epilogue(const float (&acc)[128],
                                         const float* base, const float* obs,
                                         int* cnt, float* pmax, int r0, int S,
                                         int lane, float inv_J) {
  const int q = lane & 3, grp = lane >> 2;
  const bool ok0 = ALL || r0 < S, ok1 = ALL || r0 + 8 < S;
  float m0 = -INFINITY, m1 = -INFINITY;
  // counts: column 8j + 2q + e goes to lane group 2(j % 4) + e after the
  // reduce-scatter below; in a word m = 2·group + (j / 4) % 2, field j / 8
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(base + c);
    const float2 o = *reinterpret_cast<const float2*>(obs + c);
    // the plain version's base + (G·coefT)·(1/J), each step rounded
    const float v00 = __fadd_rn(b.x, __fmul_rn(acc[4 * j + 0], inv_J));
    const float v01 = __fadd_rn(b.y, __fmul_rn(acc[4 * j + 1], inv_J));
    const float v10 = __fadd_rn(b.x, __fmul_rn(acc[4 * j + 2], inv_J));
    const float v11 = __fadd_rn(b.y, __fmul_rn(acc[4 * j + 3], inv_J));
    m0 = max_nan(m0, max_nan(v00, v01));
    m1 = max_nan(m1, max_nan(v10, v11));
    const int m = 4 * (j & 3) + ((j >> 2) & 1);
    const uint32_t one = 1u << (8 * (j >> 3));
    if constexpr (ALL) {
      count_ge(w[m], v00, o.x, one);
      count_ge(w[m], v10, o.x, one);
      count_ge(w[m + 2], v01, o.y, one);
      count_ge(w[m + 2], v11, o.y, one);
    } else {
      w[m] += (ok0 && v00 >= o.x) ? one : 0u;
      w[m] += (ok1 && v10 >= o.x) ? one : 0u;
      w[m + 2] += (ok0 && v01 >= o.y) ? one : 0u;
      w[m + 2] += (ok1 && v11 >= o.y) ? one : 0u;
    }
  }
  // row maxima: the quad (lanes 4·grp .. 4·grp + 3) holds a row's 256 cells
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = max_nan(m0, __shfl_xor_sync(FULL, m0, off));
    m1 = max_nan(m1, __shfl_xor_sync(FULL, m1, off));
  }
  if (q == 0 && ok0) pmax[r0] = m0;
  if (q == 1 && ok1) pmax[r0 + 8] = m1;
  // counts: sum the words over the 8 lanes that share q (lane bits 2-4),
  // each step keeping half: 16 words → 8 → 4 → 2, words 2·grp, 2·grp + 1
  uint32_t w8[8], w4[4], w2[2];
  const bool hi4 = lane & 16, hi3 = lane & 8, hi2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w8[i] = (hi4 ? w[i + 8] : w[i]) +
            __shfl_xor_sync(FULL, hi4 ? w[i] : w[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = (hi3 ? w8[i + 4] : w8[i]) +
            __shfl_xor_sync(FULL, hi3 ? w8[i] : w8[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (hi2 ? w4[i + 2] : w4[i]) +
            __shfl_xor_sync(FULL, hi2 ? w4[i] : w4[i + 2], 4);
  // a field sums at most 16 (8 lanes × 2 rows): 8 bits hold it.  The
  // atomics add zeros too: a branch around each cost more than the add
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int fld = 0; fld < 4; ++fld) {
      const int j = 4 * (i + 2 * fld) + (grp >> 1);
      atomicAdd(&cnt[8 * j + 2 * q + (grp & 1)],
                (int)((w2[i] >> (8 * fld)) & 0xff));
    }
}

template <bool F16>
__global__ void __launch_bounds__(THREADS, 1)
null_tile_tc_kernel(const __grid_constant__ CUtensorMap mapG,
                    const __grid_constant__ CUtensorMap mapC,
                    const float* __restrict__ base,
                    const float* __restrict__ obs,
                    float* __restrict__ partial_max,
                    int* __restrict__ counts, int S, int N, int nTN,
                    int n_units, int nST, int nK, float inv_J) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle's 1024-byte atoms; an offset keeps the pointer's shared
  // address space (a round trip through an integer would lose it)
  Shared& sh = *reinterpret_cast<Shared*>(
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));
  const int t = threadIdx.x;
  // coefT's slices of a unit stay for all its surrogate tiles when they
  // fit the ring; otherwise both operands stream
  const bool resident = nK <= B_STAGES;
  if (t == 0) {
    for (int s = 0; s < A_STAGES; ++s)
      for (int g = 0; g < 2; ++g) {
        mbar_init(&sh.full_a[g][s], 1);
        mbar_init(&sh.empty_a[g][s], WG);
      }
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&sh.full_b[s], 1);
      mbar_init(&sh.empty_b[s], CONSUMERS);
    }
    for (int g = 0; g < 2; ++g) {
      mbar_init(&sh.turn[g], WG);
      mbar_init(&sh.wg[g], WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= CONSUMERS) {
    // the producer warpgroup: one thread of warp 0 fills the coefT ring,
    // one of warp 1 (2) warpgroup 0's (1's) G ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int pw = (t - CONSUMERS) >> 5;
    if ((t & 31) == 0 && pw == 0) {
      uint32_t ib = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int f = u / nTN, n0 = (u % nTN) * BN;
        for (int st = 0; st < (resident ? 1 : nST); ++st)
          for (int k = 0; k < nK; ++k, ++ib) {
            const int slot = ib % B_STAGES;
            mbar_wait(&sh.empty_b[slot], ((ib / B_STAGES) & 1) ^ 1);
            mbar_expect_tx(&sh.full_b[slot], B_SLICE);
            for (int x = 0; x < BN / BOX; ++x)
              tma_load(sh.b[slot] + x * BOX_BYTES, &mapC, &sh.full_b[slot],
                       n0 + x * BOX, k * BK, f);
          }
      }
    } else if ((t & 31) == 0 && pw <= 2) {
      const int g = pw - 1;
      uint32_t ia = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int f = u / nTN;
        for (int st = 0; st < nST; ++st)
          for (int k = 0; k < nK; ++k, ++ia) {
            const int slot = ia % A_STAGES;
            mbar_wait(&sh.empty_a[g][slot], ((ia / A_STAGES) & 1) ^ 1);
            mbar_expect_tx(&sh.full_a[g][slot], BOX_BYTES);
            tma_load(sh.a[g][slot], &mapG, &sh.full_a[g][slot],
                     st * BM + g * BOX, k * BK, f);
          }
      }
    }
  } else {
    // consumer warpgroup g: surrogate rows 64g .. 64g + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int g = t >> 7, tg = t & (WG - 1), lane = t & 31;
    float* const base_s = sh.base[g];
    float* const obs_s = sh.obs[g];
    int* const cnt_s = sh.cnt[g];
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t ia = 0, ib = 0;            // slices consumed, per ring
    uint32_t turns = 0, wg_phase = 0;   // waits on sh.turn[g], sh.wg[g]
    bool first = true;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int f = u / nTN, n0 = (u % nTN) * BN;
      for (int c = tg; c < BN; c += WG) {
        const int n = n0 + c;
        const bool ok = n < N;
        base_s[c] = ok ? base[(size_t)f * N + n] : -INFINITY;
        obs_s[c] = ok ? obs[(size_t)f * N + n] : INFINITY;
        cnt_s[c] = 0;
      }
      wg_sync(&sh.wg[g], wg_phase);
      float* pmax = partial_max + (size_t)u * S;   // u == f · nTN + tn
      for (int st = 0; st < nST; ++st) {
        const bool free_b = !resident || st == nST - 1;
        // wait for this warpgroup's turn on the tensor cores
        if (resident && (g == 1 || !first))
          mbar_wait(&sh.turn[g], turns++ & 1);
        first = false;
        // slice k's slots: G at ia0 + k, coefT at jb0 + k
        const uint32_t ia0 = ia, jb0 = ib + (resident ? 0 : st * nK);
        // slice k's wgmmas are done: every thread arrives (a branch to
        // one lane a warp cost more than the arrivals)
        auto release = [&](int k) {
          mbar_arrive(&sh.empty_a[g][(ia0 + k) % A_STAGES]);
          if (free_b) mbar_arrive(&sh.empty_b[(jb0 + k) % B_STAGES]);
        };
        for (int k = 0; k < nK; ++k, ++ia) {
          const uint32_t jb = jb0 + k;
          const int sa = ia % A_STAGES, sb = jb % B_STAGES;
          // a resident coefT slice was waited for on the unit's first tile
          if (!resident || st == 0)
            mbar_wait(&sh.full_b[sb], (jb / B_STAGES) & 1);
          mbar_wait(&sh.full_a[g][sa], (ia / A_STAGES) & 1);
          const uint32_t a0 = smem_u32(sh.a[g][sa]);
          const uint32_t b0 = smem_u32(sh.b[sb]);
          fence_acc(acc);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BK / K_STEP; ++kk)
            wgmma<F16>(acc, mn_major_desc(a0 + kk * K_STEP * 128),
                       mn_major_desc(b0 + kk * K_STEP * 128),
                       (k | kk) != 0);
          wg_commit();
          fence_acc(acc);
          if (k >= IN_FLIGHT) {
            wg_wait<IN_FLIGHT>();
            fence_acc(acc);
            release(k - IN_FLIGHT);
          }
        }
        // the other warpgroup's turn
        if (resident) mbar_arrive(&sh.turn[1 - g]);
        wg_wait<0>();
        fence_acc(acc);
        for (int k = nK > IN_FLIGHT ? nK - IN_FLIGHT : 0; k < nK; ++k)
          release(k);
        const int r0 = st * BM + g * 64 + (tg >> 5) * 16 + (lane >> 2);
        if (r0 - (lane >> 2) + 16 <= S)   // the warp's 16 rows all real
          epilogue<true>(acc, base_s, obs_s, cnt_s, pmax, r0, S, lane, inv_J);
        else
          epilogue<false>(acc, base_s, obs_s, cnt_s, pmax, r0, S, lane, inv_J);
      }
      ib += resident ? nK : nST * nK;
      wg_sync(&sh.wg[g], wg_phase);   // the warpgroup's counts are in
      for (int c = tg; c < BN; c += WG)
        if (n0 + c < N && cnt_s[c] != 0)
          atomicAdd(&counts[(size_t)f * N + n0 + c], cnt_s[c]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query, so the library links no -lcuda
cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// (nF, JP, ld) 16-bit, the first ``width`` of ld real: boxes of 64 values
// × 64 J·P rows of one frequency, zero past width, JP and nF
cudaError_t make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                     bool f16, int width, int ld, int JP, int nF) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)JP,
                              (cuuint64_t)nF};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)ld * 2 * (cuuint64_t)JP};
  const cuuint32_t box[3] = {BOX, BK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool F16>
cudaError_t launch(const CUtensorMap& mapG, const CUtensorMap& mapC,
                   const float* base, const float* obs, float* partial_max,
                   int* counts, int nF, int S, int N, int nTN, int n_units,
                   int nST, int nK, float inv_J, cudaStream_t s) {
  auto kernel = null_tile_tc_kernel<F16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // each warpgroup adds its counts of a unit
  err = cudaMemsetAsync(counts, 0, (size_t)nF * N * sizeof(int), s);
  if (err != cudaSuccess) return err;
  const int grid = n_units < sms ? n_units : sms;
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(mapG, mapC, base, obs,
                                           partial_max, counts, S, N, nTN,
                                           n_units, nST, nK, inv_J);
  return cudaGetLastError();
}

}  // namespace

// G (nF, JP, ldg) and coefT (nF, JP, ldc), bf16 (f16 = 0) or f16, 16-byte
// aligned with ldg and ldc multiples of 8; the first S <= ldg surrogates
// and N <= ldc cells are real.  partial_max holds nF·ceil(N/256) rows of S.
extern "C" int mba_null_tile_tc(const void* G, const void* coefT,
                                const void* base, const void* obs,
                                void* partial_max, void* counts,
                                void* max_out, int nF, int S, int ldg,
                                int JP, int N, int ldc, float inv_J, int f16,
                                void* stream) {
  if (nF <= 0 || S <= 0 || S > ldg || ldg % 8 != 0 || JP <= 0 || N <= 0 ||
      N > ldc || ldc % 8 != 0 || reinterpret_cast<uintptr_t>(G) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(coefT) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)nF * ((N + BN - 1) / BN);
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = nullptr;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mapG, mapC;
  err = make_map(&mapG, encode, G, f16 != 0, S, ldg, JP, nF);
  if (err == cudaSuccess)
    err = make_map(&mapC, encode, coefT, f16 != 0, N, ldc, JP, nF);
  if (err != cudaSuccess) return (int)err;
  const int nTN = (N + BN - 1) / BN, nST = (S + BM - 1) / BM;
  const int nK = (JP + BK - 1) / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(base);
  const float* o = static_cast<const float*>(obs);
  float* pm = static_cast<float*>(partial_max);
  int* cn = static_cast<int*>(counts);
  err = f16 ? launch<true>(mapG, mapC, b, o, pm, cn, nF, S, N, nTN,
                           (int)units, nST, nK, inv_J, s)
            : launch<false>(mapG, mapC, b, o, pm, cn, nF, S, N, nTN,
                            (int)units, nST, nK, inv_J, s);
  if (err != cudaSuccess) return (int)err;
  return mba_null_reduce_max(partial_max, max_out, nF * nTN, S, stream);
}
