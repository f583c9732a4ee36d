// Beam-lineage self-attention over un-permuted KV caches (kernel K1).
//
// Replaces the TPU kernel evoke_tpu/ops/lineage_attention.py:_kernel (and its
// _kernel_fused_heads variant, launched by _lineage_call). One decode step:
// query row (s, b) attends physical beam row j of its own sample at slot t iff
// anc[s, b, t] == j and 0 < (pos - t) mod L <= age, plus its own row at slot
// pos. Scores and softmax in float32, probabilities rounded to the V dtype
// before the weighted sum (as the TPU kernel's p.astype(v.dtype)), float32
// accumulation, output rounded to the cache dtype. Output is pre-`wo`.
//
// What bounds it on the H100: bytes. Per step each sample's attended K and V
// rows are read once (at most 2 * 192 * 100 * 512 * 2 B = 39.3 MB at L = 100,
// 11.7 us at 3.35 TB/s); the operations (4 * kbeam * rows * D, about 3 a byte)
// are a hundred times under the tensor cores' line and q has kbeam rows, so
// there is no wgmma here, and no tensor-map TMA either: a box over a beam's L
// slots would read the slots beyond pos and the rows of dead beams, which
// this kernel never touches. The first design (one warp per key row, 2-byte
// loads, each row's load started after the previous row's shuffle reductions,
// V read only after the softmax) had ~0.5 MB in flight over the card and took
// 0.082 ms at the serving shape (64 samples x beam 3, L 100, d 512, 8 heads,
// bf16; H100 80GB HBM3, 700 W), 10x the 0.0084 ms bound: 38 + 75 serial
// memory latencies a block, bound by neither bytes nor arithmetic.
//
// This design keeps many bytes in flight instead:
// - grid as before, one block per (sample, head), so each attended cache
//   byte is read once per step for all kbeam queries;
// - the lineage mask is built from anc/pos/age (the _ring_masks math, the mod
//   as a conditional add; the anc loads of two 256-row turns fly together and
//   wait for nothing) and the attended rows are compacted into an ascending
//   list in shared memory (ballot + warp counts), each entry a physical row
//   with its mask bits above bit 28. Later loops divide nothing and skip
//   nothing, every warp has the same share of real rows, and the float32 sums
//   run in one order from run to run;
// - right after the list is known every thread starts 16-byte cp.async.cg
//   copies of the attended rows' dh-slices of V into a [rows][dh] tile in
//   shared memory; they travel while the K pass and the softmax run;
// - K goes straight to registers, 16 bytes a lane: dh * sizeof(T) / 16 lanes
//   cover one row slice, so one load instruction of a warp covers 32 / that
//   many rows, and each lane starts 4 independent ld.global.nc.v4 (2 KB a
//   warp, 16 KB a block) before it uses the first. q sits in registers as
//   float32; a query's dot is reduced over the row's lanes only; row groups
//   beyond the list cost nothing; each query's running maximum rides along;
// - the softmax (one warp per query, its maximum known) is two-pass over the
//   compact list's float32 scores and normalises BEFORE rounding the
//   probabilities to the V dtype, as the TPU kernel does (an online softmax
//   normalising at the end would round differently at bf16);
// - P.V reads the tile with the K pass's lane mapping (a quarter warp reads
//   128 contiguous bytes: no bank conflict), the probabilities are broadcast
//   reads, lanes of one column chunk meet by shuffles and the 8 warps through
//   shared memory.
// Registers are capped at 64 (4 blocks of 256 threads an SM, so the serving
// shape's 512 blocks run in one wave); a spill is worse here than elsewhere,
// because its reload queues behind the V copies in flight. That is why bf16
// at beam 4 (q alone: 32 registers) starts 2 K loads at a time, not 4.
//
// Measured (chip_smoke.py and scripts/k1_phase_clocks.py on the same card;
// PERF.md): 0.082 -> 0.027 ms at the serving shape, 3.2x the bound. What is
// left is not a matter of loads in flight (2 at a time take as long as 4):
// all blocks start together and stay in step, so the card is either waiting
// for K and V (about half the time, at ~2.5 TB/s) or running instructions
// (mask, scores, softmax, P.V) with the memory idle.
// Asking for K before V, K in 8 loads a lane, q in shared memory and a
// softmax across all 8 warps were each measured slower or no faster.
//
// Shared memory is sized by ops/lineage_attention.launch_plan; launch() below
// refuses a plan whose byte count disagrees with layout(). Where the V tile
// of all kbeam * L rows does not fit beside the scores (float32 or dh 128
// with a long cache), the plan gives the tile the rows that fit, and P.V reads
// the rows beyond it from device memory with the K pass's register scheme
// (no second tile stage). Where not even the list fits (kbeam * L beyond
// ~11,000 rows, which the first design took), the plan drops list and tile:
// rows are walked in place, each (query, row) pair's flag (0 attended, -1e9
// masked) standing where its score will, and the unattended rows are skipped
// by their flags.
// The fused-heads / per-head split of the TPU kernel (_kernel_for) was a
// Mosaic workaround and has no counterpart here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBeam = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;     // blocks per SM the register cap leaves room for
constexpr int kStaticSmem = 192;  // wcount and wmax of the kernel
constexpr int kPlanMismatch = -1;
constexpr int kMaskShift = 28;    // a list entry: row | attend mask << 28
constexpr int kRowMask = (1 << kMaskShift) - 1;
constexpr float kNegInf = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one 16-byte load as float32 values
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 is the upper half of a float32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

#ifdef LINEAGE_PHASE_CLOCKS
// Built only by scripts/k1_phase_clocks.py: thread 0 of each block stamps the
// SM's cycle counter and the card's nanosecond timer at the end of each phase.
constexpr int kPhases = 8;
__device__ unsigned long long* g_phase_clocks = nullptr;   // [2][blocks][kPhases]
__device__ __forceinline__ void phase_clock(int i) {
  if (threadIdx.x == 0 && g_phase_clocks != nullptr) {
    const size_t blocks = (size_t)gridDim.x * gridDim.y;
    const size_t at = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kPhases + i;
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_phase_clocks[at] = (unsigned long long)clock64();
    g_phase_clocks[blocks * kPhases + at] = ns;
  }
}
#define PHASE_CLOCK(i) phase_clock(i)
#else
#define PHASE_CLOCK(i)
#endif

// byte offsets of the dynamic shared memory's regions (launch_plan's sizes)
struct Layout {
  int s, list, part, total;   // the V tile stands first, at 0
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int kbeam, int R, int dh, int isz, int v_rows,
                                         int compact) {
  Layout l;
  l.s = align16(v_rows * dh * isz);                    // after the tile [v_rows][dh] of T
  l.list = l.s + align16(kbeam * R * 4);               // after the scores [kbeam][R] float
  l.part = l.list + (compact ? align16(R * 4) : 0);    // after the list [R] int
  l.total = l.part + kWarps * kbeam * dh * 4;          // partials [kWarps][kbeam][dh] float
  return l;
}

// grid (B, num_heads), block kThreads, dynamic shared memory layout().total
template <typename T, int DH, int KB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lineage_kernel(const T* __restrict__ q, const T* __restrict__ ck,
               const T* __restrict__ cv, const int* __restrict__ anc,
               const int* __restrict__ age, T* __restrict__ out,
               int L, int D, int pos, float scale, int v_rows, int compact) {
  constexpr int VEC = Chunk<T>::N;   // elements of one 16-byte load
  constexpr int LPR = DH / VEC;      // lanes that cover one row's dh slice
  constexpr int RPW = 32 / LPR;      // rows one load instruction of a warp covers
  // independent 16-byte K loads a lane keeps in flight (2 where q alone takes
  // 32 registers: bf16 at beam 4 would spill under the 64-register cap)
  constexpr int kLoads = KB * VEC >= 32 ? 2 : 4;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int R = KB * L;              // key rows of this sample
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = lane / LPR;       // which of the warp's RPW rows
  const int sub = lane % LPR;        // which 16-byte chunk of the row slice

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(KB, R, DH, (int)sizeof(T), v_rows, compact);
  T* vt = reinterpret_cast<T*>(smem);                          // [v_rows][DH]
  float* s = reinterpret_cast<float*>(smem + lay.s);           // [KB][R]
  int* list = compact ? reinterpret_cast<int*>(smem + lay.list) : nullptr;   // [R]
  float* part = reinterpret_cast<float*>(smem + lay.part);     // [kWarps][KB][DH]
  __shared__ int wcount[2][kWarps];          // attended rows per warp, two turns
  __shared__ float wmax[kWarps][kMaxBeam];   // each warp's score maxima
  static_assert(sizeof(wcount) + sizeof(wmax) == kStaticSmem, "static shared memory");

  PHASE_CLOCK(0);
  const int a = age ? age[b] : pos;
  const size_t row0 = (size_t)b * KB;                   // first physical row of the sample
  const size_t col0 = (size_t)h * DH + sub * VEC;       // this lane's chunk within a row
  const T* kb = ck + row0 * L * D + col0;               // + r * D: row r = j * L + t
  const T* vb = cv + row0 * L * D + col0;

  uint4 qraw[KB];   // in flight under the mask
#pragma unroll
  for (int qi = 0; qi < KB; ++qi)
    qraw[qi] = __ldg(reinterpret_cast<const uint4*>(q + (row0 + qi) * D + col0));

  // bit qi of row r's mask: query qi attends physical row r = j * L + t. The
  // anc loads wait for nothing (the age only clears the mask afterwards).
  auto row_mask = [&](int r) -> unsigned {
    if (r >= R) return 0u;
    const int j = r / L, t = r - j * L;
    int delta = pos - t;
    if (delta < 0) delta += L;
    if (delta == 0) return 1u << j;   // slot pos: query j's own row
    unsigned m = 0;
#pragma unroll
    for (int qi = 0; qi < KB; ++qi) m |= (anc[(row0 + qi) * L + t] == j ? 1u : 0u) << qi;
    return delta <= a ? m : 0u;
  };

  // lineage mask compacted in ascending order, 256 rows a turn, the loads of
  // two turns in flight together: entry li of the list is physical row r with
  // its mask, r | mask << kMaskShift. Without a list, row r's flags (0
  // attended, -1e9 masked) stand where its scores will.
  int n = 0;
  for (int c0 = 0; c0 < R; c0 += 2 * kThreads) {
    const unsigned pair[2] = {row_mask(c0 + tid), row_mask(c0 + kThreads + tid)};
#pragma unroll
    for (int turn = 0; turn < 2; ++turn) {
      const int r = c0 + turn * kThreads + tid;
      const unsigned m = pair[turn];
      if (c0 + turn * kThreads >= R) break;
      if (compact) {
        const unsigned vote = __ballot_sync(kFull, m != 0);
        if (lane == 0) wcount[turn][warp] = __popc(vote);
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int c = wcount[turn][w];
          total += c;
          if (w < warp) before += c;
        }
        const int li = n + before + __popc(vote & ((1u << lane) - 1u));
        n += total;
        if (m != 0) list[li] = r | (int)(m << kMaskShift);
      } else if (r < R) {
#pragma unroll
        for (int qi = 0; qi < KB; ++qi) s[qi * R + r] = ((m >> qi) & 1u) ? 0.f : kNegInf;
      }
    }
  }
  if (!compact) n = R;
  __syncthreads();
  PHASE_CLOCK(1);

  // V: every attended row's slice requested now, used after the softmax
  const int nv = n < v_rows ? n : v_rows;
  for (int c = tid; c < nv * LPR; c += kThreads) {
    const int li = c / LPR, ch = c % LPR;
    cp_async16(vt + (size_t)li * DH + ch * VEC,
               cv + (row0 * L + (list[li] & kRowMask)) * D + (size_t)h * DH + ch * VEC);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  PHASE_CLOCK(2);

  // entry li: the list's, or (rows walked in place) row li with its flags' bits
  auto entry = [&](int li) -> unsigned {
    if (compact) return (unsigned)list[li];
    unsigned m = 0;
#pragma unroll
    for (int qi = 0; qi < KB; ++qi) m |= (s[qi * R + li] == 0.f ? 1u : 0u) << qi;
    return (unsigned)li | (m << kMaskShift);
  };

  // K: the 16-byte chunks of row groups g0, g0 + kWarps, ... (kLoads of them)
  // of this warp, all in flight before the first is used
  auto load_k = [&](int g0, uint4 (&raw)[kLoads]) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int li = (g0 + u * kWarps) * RPW + slot;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (li < n) {
        const unsigned ent = entry(li);
        if (ent >> kMaskShift)   // in place: an unattended row is not read
          raw[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)(ent & kRowMask) * D));
      }
    }
  };

  // scores: each row read once for all KB queries; warp w takes row groups
  // w, w + kWarps, ...; the running maximum of each query rides along
  float mx[KB], qf[KB][VEC];
#pragma unroll
  for (int qi = 0; qi < KB; ++qi) {
    mx[qi] = -INFINITY;
    Chunk<T>::unpack(qraw[qi], qf[qi]);
  }
  for (int g0 = warp; g0 * RPW < n; g0 += kWarps * kLoads) {
    uint4 raw[kLoads];
    load_k(g0, raw);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if ((g0 + u * kWarps) * RPW >= n) break;   // the same for the whole warp
      const int li = (g0 + u * kWarps) * RPW + slot;
      float kf[VEC], acc[KB];
      Chunk<T>::unpack(raw[u], kf);
#pragma unroll
      for (int qi = 0; qi < KB; ++qi) {
        acc[qi] = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[qi] = fmaf(qf[qi][e], kf[e], acc[qi]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int qi = 0; qi < KB; ++qi) acc[qi] += __shfl_xor_sync(kFull, acc[qi], off);
      if (sub == 0 && li < n) {
        const unsigned m = entry(li) >> kMaskShift;
#pragma unroll
        for (int qi = 0; qi < KB; ++qi) {
          const float sc = ((m >> qi) & 1u) ? acc[qi] * scale : kNegInf;
          s[qi * R + li] = sc;
          mx[qi] = fmaxf(mx[qi], sc);
        }
      }
    }
  }
#pragma unroll
  for (int qi = 0; qi < KB; ++qi) {
    mx[qi] = warp_max(mx[qi]);
    if (lane == 0) wmax[warp][qi] = mx[qi];
  }
  __syncthreads();
  PHASE_CLOCK(3);

  // softmax per query (one warp each; its maximum is known), normalised
  // before the V-dtype rounding
  if (warp < KB) {
    float* sq = s + warp * R;
    float top = wmax[0][warp];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) top = fmaxf(top, wmax[w][warp]);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sq[i] - top);
      sq[i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int i = lane; i < n; i += 32) sq[i] = to_f(from_f<T>(sq[i] / sum));
  }
  PHASE_CLOCK(4);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  PHASE_CLOCK(5);

  // P.V with the K pass's lane mapping: the tile's rows from shared memory,
  // the rows beyond it (a plan whose tile is short) from device memory
  float acc[KB][VEC];
#pragma unroll
  for (int qi = 0; qi < KB; ++qi)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[qi][e] = 0.f;
#pragma unroll 2
  for (int g0 = warp; g0 * RPW < n; g0 += kWarps) {
    const int li = g0 * RPW + slot;
    if (li < n) {
      float p[KB];
      bool live = compact != 0;   // in place: an unattended row has p == 0
#pragma unroll
      for (int qi = 0; qi < KB; ++qi) {
        p[qi] = s[qi * R + li];
        live |= p[qi] != 0.f;
      }
      if (live) {
        const uint4 raw =
            li < v_rows
                ? *reinterpret_cast<const uint4*>(vt + (size_t)li * DH + sub * VEC)
                : __ldg(reinterpret_cast<const uint4*>(
                      vb + (size_t)(compact ? list[li] & kRowMask : li) * D));
        float vf[VEC];
        Chunk<T>::unpack(raw, vf);
#pragma unroll
        for (int qi = 0; qi < KB; ++qi)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[qi][e] = fmaf(p[qi], vf[e], acc[qi][e]);
      }
    }
  }
  // the warp's RPW rows meet by shuffles, the warps through shared memory
#pragma unroll
  for (int qi = 0; qi < KB; ++qi)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        acc[qi][e] += __shfl_xor_sync(kFull, acc[qi][e], off);
      if (slot == 0) part[(warp * KB + qi) * DH + sub * VEC + e] = acc[qi][e];
    }
  __syncthreads();
  PHASE_CLOCK(6);
  for (int i = tid; i < KB * DH; i += kThreads) {
    const int qi = i / DH, c = i % DH;
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += part[(w * KB + qi) * DH + c];
    out[(row0 + qi) * D + (size_t)h * DH + c] = from_f<T>(tot);
  }
  PHASE_CLOCK(7);
}

struct Args {
  const void *q, *ck, *cv, *anc, *age;
  void* out;
  int B, kbeam, L, D, heads, pos;
  float scale;
  int v_rows, compact, smem_bytes;
  cudaStream_t stream;
};

template <typename T, int DH, int KB>
int launch(const Args& a) {
  if (a.v_rows < 0 || a.v_rows > KB * a.L || (!a.compact && a.v_rows != 0) ||
      layout(KB, KB * a.L, DH, (int)sizeof(T), a.v_rows, a.compact).total != a.smem_bytes)
    return kPlanMismatch;
  auto kern = lineage_kernel<T, DH, KB>;
  static int smem_set = 48 * 1024 - kStaticSmem;   // the cap without opting in
  if (a.smem_bytes > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = a.smem_bytes;
  }
  kern<<<dim3(a.B, a.heads), kThreads, a.smem_bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.ck), static_cast<const T*>(a.cv),
      static_cast<const int*>(a.anc), static_cast<const int*>(a.age),
      static_cast<T*>(a.out), a.L, a.D, a.pos, a.scale, a.v_rows, a.compact);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_kb(const Args& a) {
  switch (a.kbeam) {
    case 1: return launch<T, DH, 1>(a);
    case 2: return launch<T, DH, 2>(a);
    case 3: return launch<T, DH, 3>(a);
    case 4: return launch<T, DH, 4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dh(const Args& a) {
  switch (a.D / a.heads) {
    case 32: return launch_kb<T, 32>(a);
    case 64: return launch_kb<T, 64>(a);
    case 128: return launch_kb<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. age may be NULL (batch mode: age = pos).
// q, ck, cv and out are 16-byte aligned. v_rows, compact and smem_bytes come
// from ops/lineage_attention.launch_plan. Returns cudaGetLastError() after the
// launch (0 = success), or -1 for a plan whose bytes disagree with layout().
extern "C" int lineage_attention_launch(const void* q, const void* ck, const void* cv,
                                        const void* anc, const void* age, void* out,
                                        int B, int kbeam, int L, int D, int heads,
                                        int pos, float scale, int dtype, int v_rows,
                                        int compact, int smem_bytes, void* stream) {
  if (kbeam < 1 || kbeam > kMaxBeam || L < 1 || heads < 1 || D % heads != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, ck, cv, anc, age, out, B, kbeam, L, D, heads, pos, scale,
               v_rows, compact, smem_bytes, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_dh<float>(a);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

#ifdef LINEAGE_PHASE_CLOCKS
// buf: [2][blocks][8] uint64 on the device (cycle counts, then nanoseconds),
// or NULL to stop stamping.
extern "C" int lineage_attention_phase_clocks(void* buf) {
  return (int)cudaMemcpyToSymbol(g_phase_clocks, &buf, sizeof(buf));
}
#endif
