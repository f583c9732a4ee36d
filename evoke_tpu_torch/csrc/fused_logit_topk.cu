// Fused logit projection + stage-1 top-k + logsumexp (kernel K2).
//
// Replaces the TPU kernel evoke_tpu/ops/fused_logit_topk.py:_kernel (launched
// by _pallas_topk, :147). For h [N, D], the logit head W [V, D] (the port's
// Linear layout) and bias [V], all in one dtype T (bfloat16 or float32):
//   logits = T(T(f32 sum_d h[n,d] * W[v,d]) + b[v])   (nn.Dense(dtype): two roundings)
//   lse[n] = logsumexp over v of the PRE-suppression logits (float32)
//   at suppressed ids: logits += T(-1000)   (added in T, rounded)
//   (vals, idx)[n] = top-k of the suppressed logits, ties to the lowest index
// The [N, V] logits never reach device memory.
//
// What bounds it on the H100: at the serving shape (N 192, D 512, V 30001,
// bf16) reading W is 30.7 MB (9.2 us at 3.35 TB/s) and the product is
// 5.9 GFLOP (6.0 us at 989 TFLOP/s): bytes, with the operations close behind.
//
// bfloat16 route (the serving path): tile_kernel_bf16, then merge_kernel_warp.
// - Wide tiles, one wave. A block owns BTV = 232 vocab columns and all N
//   rows: ceil(30001 / 232) = 130 tiles for 132 SMs, so each block does one
//   tile and W is read from device memory once. 232 is the narrowest multiple
//   of 8 (wgmma's N step) that fits V 30001 in one wave (224 gives 134
//   tiles; 256 gives 118 and leaves 14 SMs idle). A larger V strides the
//   blocks over the tiles (a plain loop, no scheduler).
// - Rows run in passes of up to 192, one warpgroup per 64 rows (3 at N 192,
//   2 at N 96). A fourth warpgroup would put 4 warps on each of the SM's 4
//   sub-partitions (16,384 registers each) and cap a thread at 128
//   registers, too few for 116 accumulators and the epilogue, so N > 192
//   loops over row passes. A warpgroup whose rows all lie at or past N waits
//   for and releases each stage but issues no product.
// - A ring of 2-4 shared-memory stages (the launch plan picks the count),
//   each [rows x 64] of h and [232 x 64] of W in bf16 with the 128-byte
//   swizzle, filled by TMA (cp.async.bulk.tensor.2d) from one producer
//   thread. Completion goes through "full" mbarriers (bytes landed) and
//   release through "empty" ones (every thread done). The producer is thread
//   0 of the first warpgroup, not a warp of its own: a 13th warp would share
//   a sub-partition with 3 others and cap a thread at 128 registers, as
//   above; 12 warps allow 168. It issues `stages` loads up front and refills
//   a stage as soon as every thread has released it, so the loads run ahead
//   of the products. TMA zero-fills
//   rows >= N, columns >= V and depth >= D; the epilogue masks them. W's
//   tensor map is encoded once per (pointer, shape) by the wrapper; h's at
//   every launch, passed as a __grid_constant__. At N 192 four stages take
//   217 KB of the 227 KB a block may use.
// - Tensor cores through wgmma.m64n232k16 (bf16 in, float32 accumulate), both
//   operands read from shared memory through descriptors: 116 accumulator
//   registers per thread.
// - The epilogue stays in registers. Each thread holds 58 columns of two rows
//   (r and r + 8; the 4 lanes of a quad share them). It applies the two
//   roundings (packed bf16x2 conversions and a bf16x2 bias add; the bias is
//   staged in shared memory per tile) and, in the tiles that hold one, the
//   suppression; it keeps a max and a sum of exp of the pre-suppression
//   values and a top-k per row. A logit is bf16-exact, so (value, column)
//   packs into one int whose order is the top-k order (value desc, column
//   asc), and the top-k is a branch-free min/max network. The quad merges in
//   two shuffle rounds and writes one partial per (row, tile): a max, a sum
//   and k keys widened to 64 bits (value bits, ~vocab index), ceil(V / 232)
//   x N x (2 + 2k) words, 0.8 MB at N 192 and k 3.
// - merge_kernel_warp gives each row one warp over its ~130 partials, each
//   lane loading its ~4 before merging them with the same min/max network.
// Left for later work: TMA multicast of h across a 2-block cluster (halves
// its ~25 MB of L2 re-reads per launch; but a build that skipped the h loads
// outright saved no measurable time), a producer warpgroup
// with register rebalancing (setmaxnreg), which would free the first
// warpgroup of the refills, and an epilogue that overlaps the loads (it is
// the largest part of the time and starts after the last stage lands).
//
// float32 route (chip_smoke.py's float32 checks and the CPU-parity decode;
// not the bf16 serving path): the first design, unchanged. tile_kernel<float>
// splits V into tiles of TV = 32 columns, one block per tile with all rows
// (up to 256 per pass), plain FMA products, per-row warp reductions for the
// partials; merge_kernel, one 256-thread block per row, folds them.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TV = 32;         // vocab columns per block; one per lane in the epilogue
constexpr int RG = 256;        // rows per pass
constexpr int DK = 32;         // depth chunk staged in shared memory
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
constexpr int kNoIdx = INT_MAX;
// staging (f32: RG*DK + TV*(DK+1) floats) and the C tile (RG*TV floats) alias
constexpr int kSmemBytes = (RG * DK + TV * (DK + 1)) * 4;

__device__ __forceinline__ float to_f(float x) { return x; }

// round a float32 value to T and back
__device__ __forceinline__ float round_t(float x, float) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// C[r][c] = sum_d h[r][d] * W[v0 + c][d] for r < nrows, float32 on the FMA units
__device__ void mainloop(const float* __restrict__ h, const float* __restrict__ w,
                         int D, int V, int nrows, int v0, unsigned char* sbuf, float* C) {
  float* Hs = reinterpret_cast<float*>(sbuf);  // [RG][DK]
  float* Ws = Hs + RG * DK;                    // [TV][DK + 1] (padded: no bank conflicts)
  const int c = threadIdx.x & 31;
  const int rbase = threadIdx.x >> 5;          // rows rbase + kWarps * i
  constexpr int RPT = RG / kWarps;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = threadIdx.x; e < RG * DK; e += kThreads) {
      const int r = e / DK, d = d0 + (e - r * DK);
      Hs[e] = (r < nrows && d < D) ? h[(size_t)r * D + d] : 0.f;
    }
    for (int e = threadIdx.x; e < TV * DK; e += kThreads) {
      const int cc = e / DK, k = e - cc * DK, d = d0 + k, col = v0 + cc;
      Ws[cc * (DK + 1) + k] = (col < V && d < D) ? w[(size_t)col * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < DK; ++k) {
      const float wv = Ws[c * (DK + 1) + k];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(Hs[(rbase + kWarps * i) * DK + k], wv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) C[(rbase + kWarps * i) * TV + c] = acc[i];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ h, const T* __restrict__ w, const T* __restrict__ bias,
            int N, int D, int V, int k, int n_sup, int s0, int s1, int s2, int s3,
            float* __restrict__ part_m, float* __restrict__ part_s,
            float* __restrict__ part_v, int* __restrict__ part_i) {
  __shared__ __align__(128) unsigned char sbuf[kSmemBytes];
  float* C = reinterpret_cast<float*>(sbuf);
  const int tile = blockIdx.x;
  const int v0 = tile * TV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = v0 + lane;
  const bool valid = col < V;
  const bool sup = valid && ((n_sup > 0 && col == s0) || (n_sup > 1 && col == s1) ||
                             (n_sup > 2 && col == s2) || (n_sup > 3 && col == s3));
  const float bcol = valid ? to_f(bias[col]) : 0.f;
  const T tag{};  // selects the rounding of T

  for (int r0 = 0; r0 < N; r0 += RG) {
    const int nrows = min(RG, N - r0);
    mainloop(h + (size_t)r0 * D, w, D, V, nrows, v0, sbuf, C);
    for (int r = warp; r < nrows; r += kWarps) {
      // nn.Dense(dtype): round the f32 product to T, add the bias in T
      float x = round_t(round_t(C[r * TV + lane], tag) + bcol, tag);
      float xs = sup ? round_t(x + (-1000.f), tag) : x;
      if (!valid) x = xs = -INFINITY;
      const float m = warp_max(x);
      const float ssum = warp_sum(valid ? expf(x - m) : 0.f);
      const size_t o = (size_t)tile * N + r0 + r;
      if (lane == 0) {
        part_m[o] = m;
        part_s[o] = ssum;
      }
      bool taken = !valid;
      for (int kk = 0; kk < k; ++kk) {
        float bv = taken ? -INFINITY : xs;
        int bi = taken ? kNoIdx : col;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          part_v[o * k + kk] = bv;
          part_i[o * k + kk] = bi;
        }
        if (col == bi) taken = true;
      }
    }
    __syncthreads();  // C is the next pass's staging buffer
  }
}

__device__ __forceinline__ void merge_ms(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float M = fmaxf(m, m2);
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

__device__ __forceinline__ void insert(float* tv, int* ti, int k, float v, int i) {
  if (i == kNoIdx || !better(v, i, tv[k - 1], ti[k - 1])) return;
  int p = k - 1;
  while (p > 0 && better(v, i, tv[p - 1], ti[p - 1])) {
    tv[p] = tv[p - 1];
    ti[p] = ti[p - 1];
    --p;
  }
  tv[p] = v;
  ti[p] = i;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
             const float* __restrict__ part_v, const int* __restrict__ part_i,
             int N, int NT, int k, float* __restrict__ vals, int* __restrict__ idx,
             float* __restrict__ lse) {
  __shared__ float sm[kThreads], ss[kThreads], sv[kThreads * kMaxK];
  __shared__ int si[kThreads * kMaxK];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  float m = -INFINITY, s = 0.f;
  float tv[kMaxK];
  int ti[kMaxK];
  for (int kk = 0; kk < kMaxK; ++kk) {
    tv[kk] = -INFINITY;
    ti[kk] = kNoIdx;
  }
  for (int t = tid; t < NT; t += kThreads) {  // ascending tiles
    const size_t o = (size_t)t * N + row;
    merge_ms(m, s, part_m[o], part_s[o]);
    for (int kk = 0; kk < k; ++kk) insert(tv, ti, k, part_v[o * k + kk], part_i[o * k + kk]);
  }
  sm[tid] = m;
  ss[tid] = s;
  for (int kk = 0; kk < k; ++kk) {
    sv[tid * kMaxK + kk] = tv[kk];
    si[tid * kMaxK + kk] = ti[kk];
  }
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      const int o = tid + stride;
      merge_ms(m, s, sm[o], ss[o]);
      for (int kk = 0; kk < k; ++kk) insert(tv, ti, k, sv[o * kMaxK + kk], si[o * kMaxK + kk]);
      sm[tid] = m;
      ss[tid] = s;
      for (int kk = 0; kk < k; ++kk) {
        sv[tid * kMaxK + kk] = tv[kk];
        si[tid * kMaxK + kk] = ti[kk];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    for (int kk = 0; kk < k; ++kk) {
      vals[(size_t)row * k + kk] = tv[kk];
      idx[(size_t)row * k + kk] = ti[kk];
    }
    lse[row] = m + logf(s);
  }
}

template <typename T>
int launch(const void* h, const void* w, const void* bias, void* pm, void* ps, void* pv,
           void* pi, void* vals, void* idx, void* lse, int N, int D, int V, int k,
           int n_sup, int s0, int s1, int s2, int s3, cudaStream_t st) {
  const int NT = (V + TV - 1) / TV;
  tile_kernel<T><<<NT, kThreads, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const T*>(bias), N, D,
      V, k, n_sup, s0, s1, s2, s3, static_cast<float*>(pm), static_cast<float*>(ps),
      static_cast<float*>(pv), static_cast<int*>(pi));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<N, kThreads, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(ps),
      static_cast<const float*>(pv), static_cast<const int*>(pi), N, NT, k,
      static_cast<float*>(vals), static_cast<int*>(idx), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: TMA ring + wgmma, one wave, register epilogue
// ---------------------------------------------------------------------------

constexpr int BTV = 232;             // vocab columns per tile (the wgmma N)
constexpr int BK = 64;               // depth per stage: one 128-byte swizzled row
constexpr int kRowBytes = BK * 2;    // 128
constexpr int kMaxRowPass = 192;     // three consumer warpgroups
constexpr int kAcc = BTV / 2;        // accumulator registers per thread
constexpr int kMaxSmemBf16 = 232448; // 227 KB: the most a block may use
constexpr int kErrTensorMap = -2;    // cuTensorMapEncodeTiled missing or refused

// Dynamic shared memory of one block: 1024 bytes of alignment slack, the
// stages, a full and an empty mbarrier per stage, the bias (bf16) and the
// column flags (byte) of one tile. The wrapper's launch_plan computes the same.
constexpr int bf16_smem_bytes(int rows_pass, int stages) {
  return 1024 + stages * (rows_pass + BTV) * kRowBytes + stages * 16 + BTV * 2 + BTV;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of the given parity has completed; a phase that
// never completes (a lost TMA transaction) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++spins == (1u << 28)) __trap();
  } while (!done);
}

// one TMA box of a 2-D tensor map: c0 along the contiguous axis, c1 the rows
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled rows of 64 bf16:
// start address >> 4, leading offset 1 (unused with this swizzle), stride
// 1024 bytes between groups of 8 rows, layout SWIZZLE_128B
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator reads across the wgmma waits
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 232] (+)= A[64 x 16] . B[232 x 16]^T, both K-major in shared memory.
// Register r of thread t holds row 16 (t / 32) + (t % 32) / 4 + 8 ((r / 2) % 2),
// column 8 (r / 4) + 2 (t % 4) + r % 2.
__device__ __forceinline__ void wgmma_232(float (&d)[kAcc], uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %118, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n232k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115"
      "}, %116, %117, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// A bf16-exact value and its column in the tile as one int whose signed order
// is the top-k order: the value's bits (sign-folded) above, 0xFFFF - column
// below, so an equal value goes to the lower column. kEmpty is below them all.
// The partials widen it to 64 bits: the same high half, ~index below.
constexpr int kEmpty = INT_MIN;
constexpr long long kEmpty64 = LLONG_MIN;

__device__ __forceinline__ int make_key(float x, int col) {
  const int f = __float_as_int(x + 0.f);  // -0 -> +0: equal values, equal keys
  return ((f ^ ((f >> 31) & 0x7FFFFFFF)) & (int)0xFFFF0000) | (0xFFFF - col);
}

__device__ __forceinline__ long long widen_key(int key, int v0) {
  if (key == kEmpty) return kEmpty64;
  const unsigned idx = (unsigned)(v0 + 0xFFFF - (key & 0xFFFF));
  return (long long)(key & (int)0xFFFF0000) * 4294967296LL + (long long)(0xFFFFFFFFu - idx);
}

__device__ __forceinline__ float key64_value(long long key) {  // bf16-exact: low half 0
  const int o = (int)(key >> 32);
  return __int_as_float(o ^ ((o >> 31) & 0x7FFF0000));
}

__device__ __forceinline__ int key64_index(long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFLL));
}

// descending keys t[0] >= ... >= t[KC-1]: insert x (2 KC - 1 min / max, no branch)
template <int KC, typename K>
__device__ __forceinline__ void push_key(K (&t)[KC], K x) {
#pragma unroll
  for (int p = 0; p < KC; ++p) {
    const K hi = max(t[p], x);
    x = min(t[p], x);
    t[p] = hi;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The epilogue of one pass, in registers: d holds rows rsub and rsub + 8 of
// the warpgroup, columns 8 i + 2 q + {0, 1}. MASKED tiles (a column >= V or a
// suppressed id) read the column flags; the others skip them.
template <int KC, bool MASKED>
__device__ __forceinline__ void tile_epilogue(float (&d)[kAcc], const __nv_bfloat162* bias2_s,
                                              const unsigned char* flag_s, int q, int row,
                                              int N, int tile, int k, float* __restrict__ part_m,
                                              float* __restrict__ part_s,
                                              long long* __restrict__ part_key) {
  constexpr float kLog2e = 1.4426950408889634f;
  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
  int key[2][KC];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) key[j][kk] = kEmpty;
#pragma unroll
  for (int i = 0; i < BTV / 8; ++i) {
    const __nv_bfloat162 b2 = bias2_s[4 * i + q];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // nn.Dense(dtype): round the f32 products to bf16, add the bias in bf16
      const float2 x2 = __bfloat1622float2(
          __hadd2(__floats2bfloat162_rn(d[4 * i + 2 * j], d[4 * i + 2 * j + 1]), b2));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cl = 8 * i + 2 * q + c;
        float x = c ? x2.y : x2.x, xs = x;
        if (MASKED) {
          const int f = flag_s[cl];
          if (f == 2) x = -INFINITY;
          if (f == 1) xs = round_bf16(x + (-1000.f));  // added in bf16
        }
        d[4 * i + 2 * j + c] = x;
        m[j] = fmaxf(m[j], x);
        if (!MASKED || x != -INFINITY) push_key<KC>(key[j], make_key(xs, cl));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (m[j] != -INFINITY) {
      const float nm = -m[j] * kLog2e;
#pragma unroll
      for (int i = 0; i < BTV / 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) s[j] += ex2(fmaf(d[4 * i + 2 * j + c], kLog2e, nm));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the quad shares the row
      merge_ms(m[j], s[j], __shfl_xor_sync(0xffffffffu, m[j], off),
               __shfl_xor_sync(0xffffffffu, s[j], off));
      int other[KC];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) other[kk] = __shfl_xor_sync(0xffffffffu, key[j][kk], off);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) push_key<KC>(key[j], other[kk]);
    }
    const int r = row + 8 * j;
    if (q == 0 && r < N) {
      const size_t o = (size_t)tile * N + r;
      part_m[o] = m[j];
      part_s[o] = s[j];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        if (kk < k) {
          part_key[o * k + kk] = widen_key(key[j][kk], tile * BTV);
        }
    }
  }
}

// One block per tile (striding over tiles when V needs more than one wave),
// one warpgroup per 64 rows of a pass. Thread 0 is also the producer.
template <int KC>
__global__ void __launch_bounds__(kMaxRowPass / 64 * 128, 1)
tile_kernel_bf16(const __grid_constant__ CUtensorMap hmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __nv_bfloat16* __restrict__ bias, int N, int D, int V, int k,
                 int n_sup, int s0, int s1, int s2, int s3, int rows_pass, int stages,
                 float* __restrict__ part_m, float* __restrict__ part_s,
                 long long* __restrict__ part_key) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle wants 1 KB
  const uint32_t h_bytes = rows_pass * kRowBytes;
  const uint32_t stage_bytes = h_bytes + BTV * kRowBytes;
  const uint32_t bars = base + stages * stage_bytes;  // full[s], then empty[s]
  __nv_bfloat162* bias2_s =  // the tile's bias in column pairs
      reinterpret_cast<__nv_bfloat162*>(smem_raw + (bars - raw) + 16 * stages);
  unsigned char* flag_s = reinterpret_cast<unsigned char*>(bias2_s + BTV / 2);  // 1 sup, 2 >= V
  const int n_cons = (int)blockDim.x;
  const int nk = (D + BK - 1) / BK;
  const int passes = (N + rows_pass - 1) / rows_pass;
  const int tiles = (V + BTV - 1) / BTV;
  const uint32_t total = (uint32_t)((tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                                    (int)gridDim.x * passes * nk);  // this block's stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the producer: load step j (tile, row pass, depth step) into stage j % stages
  auto issue = [&](uint32_t j) {
    const int kb = j % nk, pass = (j / nk) % passes;
    const int tile = blockIdx.x + (int)(j / (nk * passes)) * gridDim.x;
    const uint32_t s = j % stages, full = bars + 8 * s, dst = base + s * stage_bytes;
    mbar_expect_tx(full, stage_bytes);  // OOB zero-fill counts too
    tma_load_2d(dst, &hmap, full, kb * BK, pass * rows_pass);
    tma_load_2d(dst + h_bytes, &wmap, full, kb * BK, tile * BTV);
  };
  if (threadIdx.x == 0)
    for (uint32_t j = 0; j < total && j < (uint32_t)stages; ++j) issue(j);

  const int g = warp >> 2;                                  // warpgroup: rows 64 g ..
  const int q = lane & 3;                                   // column pair in each 8
  const int rsub = (warp & 3) * 16 + (lane >> 2);           // rows rsub, rsub + 8 of it
  float d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int v0 = tile * BTV;
    __syncthreads();  // the previous tile's epilogue is done with bias2_s / flag_s
    for (int c = threadIdx.x; c < BTV; c += n_cons) {
      const int col = v0 + c;
      const bool sup = (n_sup > 0 && col == s0) || (n_sup > 1 && col == s1) ||
                       (n_sup > 2 && col == s2) || (n_sup > 3 && col == s3);
      reinterpret_cast<__nv_bfloat16*>(bias2_s)[c] =
          col < V ? bias[col] : __float2bfloat16(0.f);
      flag_s[c] = col >= V ? 2 : (sup ? 1 : 0);
    }
    const bool masked = v0 + BTV > V || (n_sup > 0 && s0 >= v0 && s0 < v0 + BTV) ||
                        (n_sup > 1 && s1 >= v0 && s1 < v0 + BTV) ||
                        (n_sup > 2 && s2 >= v0 && s2 < v0 + BTV) ||
                        (n_sup > 3 && s3 >= v0 && s3 < v0 + BTV);  // block-uniform
    __syncthreads();
    for (int r0 = 0; r0 < N; r0 += rows_pass) {
      const bool active = r0 + g * 64 < N;  // warpgroup-uniform
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const uint32_t s = it % stages, ph = (it / stages) & 1;
        mbar_wait(bars + 8 * s, ph);
        if (active) {
          const uint32_t a = base + s * stage_bytes + g * 64 * kRowBytes;
          const uint32_t b = base + s * stage_bytes + h_bytes;
          fence_acc(d);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)  // 16 deep = 32 bytes along the row
            wgmma_232(d, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), (kb | kk) != 0);
          wgmma_commit();
          wgmma_wait0();
          fence_acc(d);
        }
        mbar_arrive(bars + 8 * (stages + s));
        if (threadIdx.x == 0 && it + stages < total) {  // refill once all released it
          mbar_wait(bars + 8 * (stages + s), ph);
          issue(it + stages);
        }
      }
      if (!active) continue;

      const int row = r0 + g * 64 + rsub;
      if (masked)
        tile_epilogue<KC, true>(d, bias2_s, flag_s, q, row, N, tile, k, part_m, part_s,
                                part_key);
      else
        tile_epilogue<KC, false>(d, bias2_s, flag_s, q, row, N, tile, k, part_m, part_s,
                                 part_key);
    }
  }
}

// One warp per row over its NT partials, then a butterfly across the warp.
template <int KC>
__global__ void __launch_bounds__(256)
merge_kernel_warp(const float* __restrict__ part_m, const float* __restrict__ part_s,
                  const long long* __restrict__ part_key, int N, int NT, int k,
                  float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ lse) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // the whole warp
  constexpr int U = 5;   // partials a lane loads at once: NT <= 160 in one round
  float m = -INFINITY, s = 0.f;
  long long key[KC];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) key[kk] = kEmpty64;
  for (int t0 = lane; t0 < NT; t0 += 32 * U) {
    float pm[U], ps[U];
    long long pk[U][KC];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // independent loads first, then the merges
      const int t = t0 + 32 * u;
      const size_t o = (size_t)(t < NT ? t : 0) * N + row;
      pm[u] = t < NT ? part_m[o] : -INFINITY;
      ps[u] = t < NT ? part_s[o] : 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) pk[u][kk] = t < NT && kk < k ? part_key[o * k + kk] : kEmpty64;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      merge_ms(m, s, pm[u], ps[u]);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) push_key<KC>(key, pk[u][kk]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    merge_ms(m, s, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, s, off));
    long long other[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) other[kk] = __shfl_xor_sync(0xffffffffu, key[kk], off);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) push_key<KC>(key, other[kk]);
  }
  if (lane == 0) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      if (kk < k) {
        vals[(size_t)row * k + kk] = key[kk] == kEmpty64 ? -INFINITY : key64_value(key[kk]);
        idx[(size_t)row * k + kk] = key[kk] == kEmpty64 ? kNoIdx : key64_index(key[kk]);
      }
    lse[row] = m + logf(s);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up through the runtime: no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a row-major bf16 [rows, cols] matrix in boxes of [box_rows, 64], 128-byte swizzle
int encode_rows(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrTensorMap;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int KC>
int launch_bf16(const CUtensorMap& hmap, const CUtensorMap& wmap, const void* bias, void* pm,
                void* ps, void* pkey, void* vals, void* idx, void* lse, int N, int D,
                int V, int k, int n_sup, int s0, int s1, int s2, int s3, int rows_pass,
                int stages, int smem_bytes, int grid, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_kernel_bf16<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBf16);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int threads = rows_pass / 64 * 128;
  tile_kernel_bf16<KC><<<grid, threads, smem_bytes, st>>>(
      hmap, wmap, static_cast<const __nv_bfloat16*>(bias), N, D, V, k, n_sup, s0, s1, s2, s3,
      rows_pass, stages, static_cast<float*>(pm), static_cast<float*>(ps),
      static_cast<long long*>(pkey));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel_warp<KC><<<(N + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(ps),
      static_cast<const long long*>(pkey), N, (V + BTV - 1) / BTV, k,
      static_cast<float*>(vals), static_cast<int*>(idx), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

}  // namespace

// Vocab columns per tile: the wrapper sizes the partials as ceil(V / tile) * N.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int fused_logit_topk_tile(int dtype) { return dtype == 1 ? BTV : TV; }

// W's tensor map (sizeof(CUtensorMap) = 128 bytes into map_out) for the
// bfloat16 route: W [V, D] row-major, boxes of [232 rows, 64]. Returns 0, or
// -2 when libcuda's encoder is missing or refuses the shape.
extern "C" int fused_logit_topk_encode_w(void* map_out, const void* w, int V, int D) {
  if (V < 1 || D < 8 || D % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = encode_rows(&map, w, V, D, BTV);
  if (rc == 0) memcpy(map_out, &map, sizeof(CUtensorMap));
  return rc;
}

// float32 route. Up to 4 suppressed ids (s0..s3, n_sup used).
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int fused_logit_topk_launch(const void* h, const void* w, const void* bias,
                                       void* part_m, void* part_s, void* part_v,
                                       void* part_i, void* vals, void* idx, void* lse,
                                       int N, int D, int V, int k, int n_sup, int s0,
                                       int s1, int s2, int s3, void* stream) {
  if (k < 1 || k > kMaxK || N < 1 || D < 1 || V < k || n_sup < 0 || n_sup > 4)
    return (int)cudaErrorInvalidValue;
  return launch<float>(h, w, bias, part_m, part_s, part_v, part_i, vals, idx, lse, N, D, V,
                       k, n_sup, s0, s1, s2, s3, static_cast<cudaStream_t>(stream));
}

// bfloat16 route, with the launch plan of the wrapper's launch_plan (rows per
// pass, stages, dynamic shared memory, grid) and W's tensor map from
// fused_logit_topk_encode_w. h's map is encoded here. Partials: part_m and
// part_s [ceil(V / 232) * N] float32, part_key [ceil(V / 232) * N * k] int64.
// Returns 0, a CUDA error code, or -2 (tensor map).
extern "C" int fused_logit_topk_bf16_launch(
    const void* wmap, const void* h, const void* bias, void* part_m, void* part_s,
    void* part_key, void* vals, void* idx, void* lse, int N, int D, int V, int k,
    int n_sup, int s0, int s1, int s2, int s3, int rows_pass, int stages, int smem_bytes,
    int grid, void* stream) {
  if (k < 1 || k > kMaxK || N < 1 || D < 8 || D % 8 != 0 || V < k || n_sup < 0 || n_sup > 4 ||
      rows_pass < 64 || rows_pass > kMaxRowPass || rows_pass % 64 != 0 ||
      rows_pass < (N < kMaxRowPass ? N : kMaxRowPass) || stages < 2 || stages > 8 ||
      smem_bytes != bf16_smem_bytes(rows_pass, stages) || smem_bytes > kMaxSmemBf16 ||
      grid < 1 || reinterpret_cast<uintptr_t>(h) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap, wm;
  memcpy(&wm, wmap, sizeof(CUtensorMap));
  const int rc = encode_rows(&hmap, h, N, D, rows_pass);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // two instantiations: the beam's k 3 and the most, 8; a smaller k keeps a
  // prefix of the sorted top-3 or top-8
  if (k <= 3)
    return launch_bf16<3>(hmap, wm, bias, part_m, part_s, part_key, vals, idx, lse, N, D, V, k,
                          n_sup, s0, s1, s2, s3, rows_pass, stages, smem_bytes, grid, st);
  return launch_bf16<8>(hmap, wm, bias, part_m, part_s, part_key, vals, idx, lse, N, D, V, k,
                        n_sup, s0, s1, s2, s3, rows_pass, stages, smem_bytes, grid, st);
}
