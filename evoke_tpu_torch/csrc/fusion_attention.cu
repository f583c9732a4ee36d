// Masked cross-view fusion attention (kernel K3).
//
// Replaces the TPU kernel evoke_tpu/ops/fusion_attention.py
// masked_cross_view_attention (:86, body _kernel :36). Anchor q attends all
// B*T batch key rows under a per-(anchor, sample) mask: key row r belongs to
// sample r / t_tokens and is kept where mask[q, sample] != 0. Scores are
// float32 from the input dtype, multiplied by 1/sqrt(dk); an online softmax in
// float32; out = acc / max(l, 1e-30), rounded to q's dtype (the TPU kernel's
// numerics, not dot_attention's, which rounds the probabilities to V's dtype).
//
// What bounds it on the H100: at the fusion module's shapes (dk 2048 with
// wide qkv, T 50, 8 heads) an anchor attends 1-4 samples of the 64-128 in the
// batch. The least work is the bytes of q, the output and the attended K/V
// rows (3.35 TB/s) against 4 * T * T * dk operations per (anchor, head,
// attended sample) (989 TFLOP/s bf16, 67 TFLOP/s float32): bytes bound it by
// 10x at bf16. So the design reads q and the attended k and v rows once each,
// by 16-byte asynchronous copies, and hides the arithmetic under them.
//
// Design, the cluster route (cluster_kernel):
// - The [T, dk] float32 accumulator of one (anchor, head) is 400 KB at dk
//   2048, more than an SM holds. The output is cut into 64-row query tiles and
//   dk chunks of CH columns (256 at dk 2048); the C = ceil(dk / CH) <= 8 blocks
//   of one (anchor, head, row tile) are launched as one thread-block cluster.
//   A block keeps only its own [T, CH] slice of q in shared memory and, per
//   attended 32-key tile, loads only its own [32, CH] slices of k and v.
// - Each score tile is computed once: a block multiplies its slices into a
//   partial [64, 64] tile (a pair of key tiles) over its chunk of dk and
//   writes each strip of rows into the shared memory of the block that owns
//   those rows (block c owns rows c * RPC .., RPC = ceil(64 / C)). The owner
//   sums the C partials in a fixed order, runs the online-softmax update for
//   its rows (m and l live there) and writes the probabilities, the
//   correction and l into every block's shared memory; then every block adds
//   p.v for its own columns, tile by tile. The writes are st.async stores
//   that report their bytes to an mbarrier of the receiving block, so a block
//   waits only for the data it needs (the strips of its rows; the
//   probabilities of all rows) and the cluster's own barrier is used once, at
//   the start. The data flow also orders every reuse of a buffer: the next
//   exchange's strips leave a block only after it holds this exchange's
//   probabilities, which an owner sends only after reading this exchange's
//   strips. No atomics on data: two calls on the same inputs give the same
//   bits.
// - bf16: q.k^T and p.v on the tensor cores (mma.sync.m16n8k16, operands by
//   ldmatrix, rows padded by 16 bytes so no load has a bank conflict).
//   mma.sync rather than wgmma: the operations are 10x under the bytes, so the
//   older instruction's rate is ample, and its fragments take P from a plain
//   row-major tile and V through ldmatrix.trans with no swizzled descriptor.
//   The float32 probability (float32 as it crosses the cluster) is split by
//   the receiving block into two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
//   one MMA each against the bf16 V tile with float32 sums: V is exact in
//   bf16, so p enters with 16 bits (2^-17 relative), 256 times below the
//   rounding of the bf16 output. float32 inputs: FMA for both products (V is
//   not exact in bf16, and TF32 would change the numerics), with p in
//   float32.
// - k and v tiles arrive by cp.async.cg (16 bytes, zero-filled past the
//   sample's last key, past T and past dk, so stale shared memory never meets
//   a zero probability) into a ring of three tiles: an exchange's two k tiles
//   and its first v tile are in flight together, its second v tile and the
//   next exchange's k tiles are requested as soon as a slot is free, and v is
//   waited for only before p.v. At T 50, dk 2048, bf16 a block takes 111 KB of
//   shared memory, so two blocks share an SM and one cluster's loads, waits
//   and output run under another's arithmetic.
// - Samples the mask excludes are skipped: each block compacts its anchor's
//   mask row into a list (256 samples at a time) and walks the attended
//   samples only. Skipping is exact: on the TPU a masked key's -1e9 score adds
//   exp(-1e9 - m) = 0 once a kept key has set m, and before that the dummy
//   sums are wiped by a correction of exactly 0. The caller guarantees every
//   anchor attends at least one sample (its self slot).
// - q, k and v are read in place through element strides (the module passes
//   views of its projection outputs); the last dimension must be contiguous.
//
// The recompute route (recompute_kernel) is the first design, kept for what
// the cluster route does not take: rows that are not 16-byte aligned (scalar
// loads) and dk above 8 chunks. Grid (anchor, head, 256-column chunk x row
// tile); every block recomputes the score tile over the full dk.
// ops/fusion_attention.launch_plan chooses the route and sizes the launch;
// this file refuses a plan whose shared-memory bytes disagree with its own.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kRows = 64;      // query rows per block
constexpr float kNegInf = -1e9f;

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

#ifdef FUSION_PHASE_CLOCKS
// Built only by scripts/k3_phase_clocks.py: thread 0 of each block of the
// cluster route stamps the SM's cycle counter and the card's nanosecond timer
// at the end of each phase of its first exchange, and before and after the
// output.
constexpr int kPhases = 12;
__device__ unsigned long long* g_phase_clocks = nullptr;   // [2][blocks][kPhases]
__device__ __forceinline__ void phase_clock(int i) {
  if (threadIdx.x == 0 && g_phase_clocks != nullptr) {
    const size_t blocks = (size_t)gridDim.x * gridDim.y * gridDim.z;
    const size_t at = (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x)
                      * kPhases + i;
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

// ---------------------------------------------------------------------------
// The cluster route
// ---------------------------------------------------------------------------

constexpr int kListCap = 256;   // attended samples compacted at a time

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d += a[16x16, row] . b[16x8, col], bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of this block's shared-memory offset `addr` in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(addr), "r"(rank));
  return d;
}
// a store into another block's shared memory that reports its bytes to that
// block's mbarrier `bar` (both addresses from map_rank)
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t bar, float v) {
  asm volatile("st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               :: "r"(addr), "f"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t bar, float a, float b) {
  asm volatile("st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
               "[%0], {%1, %2}, [%3];\n"
               :: "r"(addr), "f"(a), "f"(b), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// one arrival that also announces the bytes this phase will receive
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// returns once the phase of the given parity has completed (its bytes are visible)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// the cluster's barrier, used once: no block writes into another before all
// have started and initialised their mbarriers
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the two bf16 terms of a pair of float32 probabilities, as MMA operand words
__device__ __forceinline__ void split_pair(float2 p, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p.x - __low2float(h), p.y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

constexpr int kKT = 32;         // keys of one k or v tile
constexpr int kGK = 2 * kKT;    // keys of one exchange: a pair of tiles
constexpr int kNW = 8;          // warps

// The shared-memory layout of one block, in bytes (launch_plan repeats it):
// q's slice (rows past T are never loaded: a row tile's operand loads then
// read the ring, and those rows' results are never stored), a ring of three
// k or v tiles, the strips received ([C * RPC rows][64 keys] float32), the
// probabilities ([64][64 + 8] float32, then in the same room their hi and lo
// bf16 tiles), corr and l received and m and l owned, the sample list, the
// per-warp counts, two mbarriers.
template <typename T, int CH>
struct Layout {
  static constexpr bool bf = sizeof(T) == 2;
  static constexpr int threads = kNW * 32;
  static constexpr int epg = 16 / (int)sizeof(T);        // elements per 16-byte granule
  static constexpr int gpr = CH / epg;                   // granules per row
  static constexpr int ldb = CH * (int)sizeof(T) + 16;   // q/k/v row stride
  static constexpr int ldp = (kGK + 8) * 4;              // probability row stride (float32)
  static constexpr int ldh = kGK * 2 + 16;               // bf16 hi / lo row stride (in p's room)
  static_assert(2 * kRows * ldh == kRows * ldp, "hi and lo tiles fill the float32 tile's room");
  static constexpr int tile_bytes = kKT * ldb;
  // bf16: compiled so that two blocks share an SM (128 registers a thread) where their
  // shared memory allows it (T <= 53 at 256 columns)
  static constexpr int min_blocks = bf ? 2 : 1;
  int kv_off, recv_off, p_off, stat_off, list_off, wcnt_off, bar_off, bytes;
  __host__ __device__ Layout(int TQ, int C) {
    const int rpc = (kRows + C - 1) / C;
    kv_off = min(kRows, TQ) * ldb;
    recv_off = kv_off + 3 * tile_bytes;
    p_off = recv_off + C * rpc * kGK * 4;
    stat_off = p_off + kRows * ldp;
    list_off = stat_off + 4 * kRows * 4;
    wcnt_off = list_off + kListCap * 4;
    bar_off = wcnt_off + 64;
    bytes = bar_off + 16;
  }
};

// rows [0, n_rows) of a [*, CH] tile from `src` (row stride in elements) into
// shared memory at `dst`; rows >= n_valid and columns >= dk arrive as zeros
template <typename L, typename T>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, long long row_stride,
                                          int n_rows, int n_valid, int c0, int dk, int tid) {
  for (int idx = tid; idx < n_rows * L::gpr; idx += L::threads) {
    const int r = idx / L::gpr, gc = idx - r * L::gpr;
    const int col = c0 + gc * L::epg;
    const bool ok = r < n_valid && col < dk;
    const T* s = ok ? src + (long long)r * row_stride + col : src;
    cp_async16(dst + r * L::ldb + gc * 16, s, ok ? 16 : 0);
  }
}

// grid (Q * C, heads, row tiles), cluster (C, 1, 1), block 256
template <typename T, int CH>
__global__ void __launch_bounds__(kNW * 32, Layout<T, CH>::min_blocks)
cluster_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const unsigned char* __restrict__ mask, T* __restrict__ out,
               int H, int TQ, int dk, int B, int tt,
               long long sq0, long long sq1, long long sq2,
               long long sk0, long long sk1, long long sv0, long long sv1,
               float scale, int C) {
  using L = Layout<T, CH>;
  constexpr bool bf = L::bf;
  constexpr int ldb = L::ldb, ldp = L::ldp, ldh = L::ldh;
  const L lay(TQ, C);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const uint32_t q_u32 = sbase;
  const uint32_t p_u32 = sbase + lay.p_off;
  float* recv = reinterpret_cast<float*>(smem + lay.recv_off);
  float* corr_s = reinterpret_cast<float*>(smem + lay.stat_off);  // [kRows] received
  float* lsum_s = corr_s + kRows;                                 // [kRows] received
  float* m_own = lsum_s + kRows;                                  // rows this block owns
  float* l_own = m_own + kRows;
  int* list = reinterpret_cast<int*>(smem + lay.list_off);
  int* wcnt = reinterpret_cast<int*>(smem + lay.wcnt_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_rank();
  const int qi = blockIdx.x / C, hh = blockIdx.y, r0 = blockIdx.z * kRows;
  const int c0 = rank * CH;
  const int rpc = (kRows + C - 1) / C;                 // rows a block owns
  const int own0 = rank * rpc;
  const int n_own = max(0, min(rpc, kRows - own0));
  const T* qb = q + (long long)qi * sq0 + (long long)hh * sq1 + (long long)r0 * sq2;
  const T* kb = k + (long long)hh * sk0;
  const T* vb = v + (long long)hh * sv0;
  const unsigned char* mrow = mask + (long long)qi * B;
  // strips for the rows this block owns report to bar_recv, the probabilities
  // and softmax state of all 64 rows to bar_p: one phase of each per exchange
  const uint32_t bar_recv = sbase + lay.bar_off, bar_p = bar_recv + 8;
  const uint32_t recv_tx = (uint32_t)n_own * kGK * 4 * C, p_tx = kRows * (kGK * 4 + 8);
  PHASE_CLOCK(0);
  if (tid == 0) {
    mbar_init(bar_recv, 1);
    mbar_init(bar_p, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  for (int r = tid; r < kRows; r += L::threads) {
    m_own[r] = kNegInf;
    l_own[r] = 0.f;
    corr_s[r] = 0.f;
    lsum_s[r] = 0.f;
  }
  cluster_arrive();      // waited for before this block's first remote store
  const bool flag0 = tid < kListCap && tid < B && mrow[tid] != 0;   // ahead of q's requests
  bool started = false;
  uint32_t phase = 0;    // exchanges done: the mbarriers' phase
  // q's slice: requested now, lands with the first k tile's group
  load_rows<L>(q_u32, qb, sq2, min(kRows, TQ), TQ - r0, c0, dk, tid);

  // the accumulator: bf16 [4 row tiles][n-tiles of this warp's columns][4];
  // float32 [8 rows of this warp][CH / 32 columns of this lane]
  constexpr int WC = CH / kNW;           // bf16: output columns per warp
  constexpr int PNT = WC / 8;
  constexpr int NACC = bf ? 4 * PNT * 4 : 8 * (CH / 32);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const int n_kt = (tt + kKT - 1) / kKT;      // key tiles of one sample
  const int n_g = (n_kt + 1) / 2;             // exchanges of one sample: pairs of tiles
  for (int base = 0; base < B; base += kListCap) {
    // ---- compact the attended samples of [base, base + 256) into list ----
    const bool flag = base == 0 ? flag0
                                : tid < kListCap && base + tid < B && mrow[base + tid] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < kNW; ++w) {
      const int c = wcnt[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (flag) list[off + __popc(bal & ((1u << lane) - 1u))] = base + tid;
    __syncthreads();
    const int ng = total * n_g;
    if (ng == 0) continue;

    // load n of this batch lands in ring slot n % 3. Exchange g takes loads
    // 4 g .. 4 g + 3: k of its first tile, k of its second, v of its first, v
    // of its second (one group each; an empty group where there is no tile)
    auto request = [&](int n) {
      const int g = n >> 2, second = n & 1;
      if (g < ng) {
        const int k0 = ((g % n_g) * 2 + second) * kKT;
        if (k0 < tt) {
          const long long key0 = (long long)list[g / n_g] * tt + k0;
          const T* src = (n & 2) ? vb + key0 * sv1 : kb + key0 * sk1;
          load_rows<L>(sbase + lay.kv_off + (n % 3) * L::tile_bytes, src, (n & 2) ? sv1 : sk1,
                       kKT, min(kKT, tt - k0), c0, dk, tid);
        }
      }
      cp_commit();
    };
    auto slot = [&](int n) { return sbase + lay.kv_off + (n % 3) * L::tile_bytes; };
    request(0);
    request(1);
    request(2);
    if (base == 0) PHASE_CLOCK(1);

    for (int g = 0; g < ng; ++g) {
      const bool stamp = base == 0 && g == 0;
      const int k0 = (g % n_g) * kGK;
      const int nkg = min(kGK, tt - k0);        // keys of this exchange
      const int nk_a = min(kKT, nkg), nk_b = nkg - nk_a;
      cp_wait<1>();              // q and both k tiles have landed (v may be in flight)
      __syncthreads();           // ... for every thread
      if (tid == 0) {
        mbar_expect_tx(bar_recv, recv_tx);
        mbar_expect_tx(bar_p, p_tx);
      }
      if (stamp) PHASE_CLOCK(2);

      // ---- partial scores of both tiles over this block's chunk of dk, and the
      // strips of the partial [64, 64] tile to the blocks that own their rows ----
      if constexpr (bf) {
        // warp (rt, kg): rows rt * 16 .., keys kg * 16 .. of each tile
        const int rt = warp & 3, kg = warp >> 2;
        float s[2][2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[t][n][e] = 0.f;
        const uint32_t a_addr = q_u32 + (rt * 16 + (lane & 15)) * ldb + (lane >> 4) * 16;
        const uint32_t b_off = (kg * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * ldb
                               + ((lane >> 3) & 1) * 16;
        const uint32_t b_addr[2] = {slot(4 * g) + b_off, slot(4 * g + 1) + b_off};
#pragma unroll
        for (int kk = 0; kk < CH; kk += 16) {
          uint32_t a[4];
          ldsm_x4(a, a_addr + kk * 2);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            uint32_t b[4];
            ldsm_x4(b, b_addr[t] + kk * 2);
            mma_bf16(s[t][0], a, b[0], b[1]);
            mma_bf16(s[t][1], a, b[2], b[3]);
          }
        }
        if (stamp) PHASE_CLOCK(3);
        if (!started) cluster_wait();
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int row = rt * 16 + (lane >> 2) + 8 * hlf;
          const int owner = row / rpc, rr = row - owner * rpc;
          const uint32_t dst = map_rank(
              sbase + lay.recv_off + ((rank * rpc + rr) * kGK + kg * 16 + 2 * (lane & 3)) * 4,
              owner);
          const uint32_t bar = map_rank(bar_recv, owner);
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int n = 0; n < 2; ++n)
              st_async(dst + (t * kKT + n * 8) * 4, bar, s[t][n][2 * hlf], s[t][n][2 * hlf + 1]);
        }
      } else {
        // thread (ty, tx): rows ty, ty + 32; keys tx + 8 j of each tile
        const int ty = tid >> 3, tx = tid & 7;
        float s[2][2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[t][a][j] = 0.f;
        const unsigned char* qs = smem + ty * ldb;
        const unsigned char* ks[2] = {smem + (slot(4 * g) - sbase) + tx * ldb,
                                      smem + (slot(4 * g + 1) - sbase) + tx * ldb};
#pragma unroll 2
        for (int d = 0; d < CH; d += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + d * 4);
          const float4 qc = *reinterpret_cast<const float4*>(qs + 32 * ldb + d * 4);
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 kv = *reinterpret_cast<const float4*>(ks[t] + 8 * j * ldb + d * 4);
              s[t][0][j] += qa.x * kv.x + qa.y * kv.y + qa.z * kv.z + qa.w * kv.w;
              s[t][1][j] += qc.x * kv.x + qc.y * kv.y + qc.z * kv.z + qc.w * kv.w;
            }
        }
        if (stamp) PHASE_CLOCK(3);
        if (!started) cluster_wait();
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int row = ty + 32 * a;
          const int owner = row / rpc, rr = row - owner * rpc;
          const uint32_t dst = map_rank(
              sbase + lay.recv_off + ((rank * rpc + rr) * kGK + tx) * 4, owner);
          const uint32_t bar = map_rank(bar_recv, owner);
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int j = 0; j < 4; ++j) st_async(dst + (t * kKT + 8 * j) * 4, bar, s[t][a][j]);
        }
      }
      started = true;
      if (stamp) PHASE_CLOCK(4);
      if (warp < n_own) mbar_wait(bar_recv, phase & 1);   // every block's strips for my rows
      if (stamp) PHASE_CLOCK(5);

      // ---- the owner's rows: sum the partials, online softmax, publish ----
      for (int rr = warp; rr < n_own; rr += kNW) {
        const int row = own0 + rr;
        float sc[2] = {0.f, 0.f}, p[2];          // keys 2 lane, 2 lane + 1
        for (int c = 0; c < C; ++c) {
          const float2 t = *reinterpret_cast<const float2*>(
              recv + (c * rpc + rr) * kGK + lane * 2);
          sc[0] += t.x;
          sc[1] += t.y;
        }
        float mx = -INFINITY;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[e] = lane * 2 + e < nkg ? sc[e] * scale : -INFINITY;
          mx = fmaxf(mx, sc[e]);
        }
        const float m_old = m_own[row];
        const float m_new = fmaxf(m_old, warp_max(mx));
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = lane * 2 + e < nkg ? expf(sc[e] - m_new) : 0.f;
          psum += p[e];
        }
        psum = warp_sum(psum);
        const float corr = expf(m_old - m_new);
        const float l_new = l_own[row] * corr + psum;
        __syncwarp();
        if (lane == 0) {
          m_own[row] = m_new;
          l_own[row] = l_new;
        }
        if (lane < C) {
          const uint32_t st = map_rank(sbase + lay.stat_off + row * 4, lane);
          const uint32_t bar = map_rank(bar_p, lane);
          st_async(st, bar, corr);
          st_async(st + kRows * 4, bar, l_new);
        }
        for (int c = 0; c < C; ++c)
          st_async(map_rank(p_u32 + row * ldp + lane * 8, c), map_rank(bar_p, c), p[0], p[1]);
      }
      if (stamp) PHASE_CLOCK(6);
      // probabilities, corrections and l of all 64 rows have arrived; every owner
      // has then seen all strips, so every warp here is done with this exchange's k
      mbar_wait(bar_p, phase & 1);
      ++phase;
      request(4 * g + 3);        // the second tile's v, into the slot of the first's k
      request(4 * g + 4);        // the next exchange's first k, into the slot of the second's k
      cp_wait<2>();              // the first tile's v has landed
      if (stamp) PHASE_CLOCK(7);

      // ---- acc = acc * corr + p . v over this block's columns, tile by tile ----
      if constexpr (bf) {
        // the float32 probabilities become their two bf16 terms in place: every
        // thread reads its share, then all write (hi tile, then lo tile)
        constexpr int NG = kRows * kGK / 4 / L::threads;    // float4 granules a thread
        float4 pf[NG];
#pragma unroll
        for (int e = 0; e < NG; ++e) {
          const int idx = tid + e * L::threads, r = idx / (kGK / 4), c4 = idx % (kGK / 4);
          pf[e] = *reinterpret_cast<const float4*>(smem + lay.p_off + r * ldp + c4 * 16);
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < NG; ++e) {
          const int idx = tid + e * L::threads, r = idx / (kGK / 4), c4 = idx % (kGK / 4);
          uint2 hi, lo;
          split_pair(make_float2(pf[e].x, pf[e].y), hi.x, lo.x);
          split_pair(make_float2(pf[e].z, pf[e].w), hi.y, lo.y);
          unsigned char* dst = smem + lay.p_off + r * ldh + c4 * 8;
          *reinterpret_cast<uint2*>(dst) = hi;
          *reinterpret_cast<uint2*>(dst + kRows * ldh) = lo;
        }
        const int gq = lane >> 2;
#pragma unroll
        for (int rt = 0; rt < 4; ++rt)
#pragma unroll
          for (int hlf = 0; hlf < 2; ++hlf) {
            const float cr = corr_s[rt * 16 + gq + 8 * hlf];
#pragma unroll
            for (int n = 0; n < PNT; ++n) {
              acc[(rt * PNT + n) * 4 + 2 * hlf] *= cr;
              acc[(rt * PNT + n) * 4 + 2 * hlf + 1] *= cr;
            }
          }
      } else {
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const float cr = corr_s[warp * 8 + rr];
#pragma unroll
          for (int c = 0; c < CH / 32; ++c) acc[rr * (CH / 32) + c] *= cr;
        }
      }
      __syncthreads();           // hi and lo tiles written; v as every thread copied it

      // p . v of one tile: keys t * 32 .. of the exchange, v in ring slot 4 g + 2 + t
      auto p_dot_v = [&](int t, int nk) {
        const uint32_t v_u32 = slot(4 * g + 2 + t);
        if constexpr (bf) {
          const uint32_t vb_addr = v_u32 + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldb
                                   + (warp * WC + ((lane >> 4) & 1) * 8) * 2;
          const uint32_t p_addr = p_u32 + (lane & 15) * ldh + (lane >> 4) * 16 + t * kKT * 2;
          const int ksteps = (nk + 15) >> 4;
#pragma unroll
          for (int ks = 0; ks < kKT / 16; ++ks) {
            if (ks >= ksteps) break;
            uint32_t b[PNT / 2][4];
#pragma unroll
            for (int np = 0; np < PNT / 2; ++np)
              ldsm_x4_trans(b[np], vb_addr + ks * 16 * ldb + np * 32);
#pragma unroll
            for (int rt = 0; rt < 4; ++rt) {
              uint32_t hi[4], lo[4];
              ldsm_x4(hi, p_addr + rt * 16 * ldh + ks * 32);
              ldsm_x4(lo, p_addr + kRows * ldh + rt * 16 * ldh + ks * 32);
#pragma unroll
              for (int n = 0; n < PNT; ++n) {
                float (&d)[4] = *reinterpret_cast<float (*)[4]>(&acc[(rt * PNT + n) * 4]);
                mma_bf16(d, hi, b[n >> 1][(n & 1) * 2], b[n >> 1][(n & 1) * 2 + 1]);
                mma_bf16(d, lo, b[n >> 1][(n & 1) * 2], b[n >> 1][(n & 1) * 2 + 1]);
              }
            }
          }
        } else {
          // warp: rows 8 warp ..; lane: columns lane * 4 + 128 e
          constexpr int NV = CH / 128;
          const unsigned char* ps = smem + lay.p_off + warp * 8 * ldp + t * kKT * 4;
          const unsigned char* vs = smem + (v_u32 - sbase) + lane * 16;
          for (int kk = 0; kk < nk; kk += 4) {      // keys past nk: p = 0, v = 0
            float4 pr[8];
#pragma unroll
            for (int rr = 0; rr < 8; ++rr)
              pr[rr] = *reinterpret_cast<const float4*>(ps + rr * ldp + kk * 4);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int e = 0; e < NV; ++e) {
                const float4 vv = *reinterpret_cast<const float4*>(vs + (kk + j) * ldb + e * 512);
#pragma unroll
                for (int rr = 0; rr < 8; ++rr) {
                  const float pv = j == 0 ? pr[rr].x : j == 1 ? pr[rr].y : j == 2 ? pr[rr].z
                                                                                   : pr[rr].w;
                  float* a = &acc[(rr * NV + e) * 4];
                  a[0] = fmaf(pv, vv.x, a[0]);
                  a[1] = fmaf(pv, vv.y, a[1]);
                  a[2] = fmaf(pv, vv.z, a[2]);
                  a[3] = fmaf(pv, vv.w, a[3]);
                }
              }
            }
          }
        }
      };
      p_dot_v(0, nk_a);
      cp_wait<1>();              // the second tile's v has landed
      __syncthreads();           // ... for every thread; the first tile's v is free
      request(4 * g + 5);        // the next exchange's second k, into that slot
      if (stamp) PHASE_CLOCK(8);
      if (nk_b > 0) p_dot_v(1, nk_b);
      __syncthreads();           // the second tile's v is free
      request(4 * g + 6);        // the next exchange's first v, into that slot
      if (stamp) PHASE_CLOCK(9);
    }
    cp_wait<0>();
  }
  if (!started) cluster_wait();
  PHASE_CLOCK(10);
  cp_commit();
  cp_wait<0>();
  __syncthreads();       // every warp is past its last use of q, k and v

  // ---- out = acc / max(l, 1e-30) ----
  T* ob = out + (((long long)qi * H + hh) * TQ + r0) * (long long)dk;
  const int n_rows = min(kRows, TQ - r0);
  if constexpr (bf) {
    // through q's shared-memory slice, so the rows leave as 16-byte stores
    const int gq = lane >> 2;
#pragma unroll
    for (int rt = 0; rt < 4; ++rt)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = rt * 16 + gq + 8 * hlf;
        if (row >= n_rows) continue;
        const float inv = 1.f / fmaxf(lsum_s[row], 1e-30f);
#pragma unroll
        for (int n = 0; n < PNT; ++n) {
          const int col = warp * WC + n * 8 + 2 * (lane & 3);
          *reinterpret_cast<__nv_bfloat162*>(smem + row * ldb + col * 2) =
              __floats2bfloat162_rn(acc[(rt * PNT + n) * 4 + 2 * hlf] * inv,
                                    acc[(rt * PNT + n) * 4 + 2 * hlf + 1] * inv);
        }
      }
    __syncthreads();
    for (int idx = tid; idx < n_rows * L::gpr; idx += L::threads) {
      const int r = idx / L::gpr, gc = idx - r * L::gpr;
      const int col = c0 + gc * L::epg;
      if (col < dk)
        *reinterpret_cast<uint4*>(ob + (long long)r * dk + col) =
            *reinterpret_cast<const uint4*>(smem + r * ldb + gc * 16);
    }
  } else {
    constexpr int NV = CH / 128;
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int row = warp * 8 + rr;
      if (row >= n_rows) continue;
      const float inv = 1.f / fmaxf(lsum_s[row], 1e-30f);
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int col = c0 + lane * 4 + 128 * e;
        const float* a = &acc[(rr * NV + e) * 4];
        if (col < dk)
          *reinterpret_cast<float4*>(ob + (long long)row * dk + col) =
              make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
      }
    }
  }
  PHASE_CLOCK(11);
}

template <typename T, int CH>
int launch_cluster(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int Q, int H, int TQ, int dk, int B, int tt, long long sq0, long long sq1,
                   long long sq2, long long sk0, long long sk1, long long sv0, long long sv1,
                   float scale, int cluster, int smem_bytes, cudaStream_t stream) {
  using L = Layout<T, CH>;
  const L lay(TQ, cluster);
  if (smem_bytes != lay.bytes || cluster != (dk + CH - 1) / CH) return -1;
  auto kern = cluster_kernel<T, CH>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       lay.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)Q * cluster, H, (TQ + kRows - 1) / kRows);
  cfg.blockDim = dim3(L::threads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
                         static_cast<T*>(out), H, TQ, dk, B, tt, sq0, sq1, sq2, sk0, sk1, sv0,
                         sv1, scale, cluster);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The recompute route (the first design)
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;      // key rows per tile
constexpr int kDS = 64;        // dk slice of the score product
constexpr int kCols = 256;     // output columns per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr int kColsPerLane = kCols / 32;      // 8
constexpr int kLdS = kKeys + 4;               // score tile row stride (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// q/k slice row stride in shared memory: a multiple of 8 bf16 (WMMA) with a
// 16-byte skew; float32 rows get one float of skew against bank conflicts.
template <typename T> struct Slice { static constexpr int ld = kDS + 1; };
template <> struct Slice<__nv_bfloat16> { static constexpr int ld = kDS + 8; };

template <typename T>
constexpr size_t recompute_smem_bytes() {
  return (size_t)kRows * kLdS * 4          // scores / probabilities
         + (size_t)kKeys * kCols * 4       // V tile, float32
         + (size_t)3 * kRows * 4           // m, l, correction
         + (size_t)2 * kRows * Slice<T>::ld * sizeof(T);  // q, k slices
}

// S[64][kLdS] = scale * Qs . Ks^T over one dk slice, accumulated across slices.
// bf16: each warp owns two 16x16 output tiles held in WMMA fragments.
struct TensorScores {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  __device__ void zero() {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
  }
  __device__ void step(const __nv_bfloat16* Qs, const __nv_bfloat16* Ks, int warp) {
    constexpr int ld = Slice<__nv_bfloat16>::ld;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = warp + t * kWarps, ti = tile >> 2, tj = tile & 3;
#pragma unroll
      for (int kk = 0; kk < kDS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + ti * 16 * ld + kk, ld);
        wmma::load_matrix_sync(b, Ks + tj * 16 * ld + kk, ld);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
  }
  __device__ void store(float* S, float scale, int warp) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = warp + t * kWarps, ti = tile >> 2, tj = tile & 3;
#pragma unroll
      for (int i = 0; i < acc[t].num_elements; ++i) acc[t].x[i] *= scale;
      wmma::store_matrix_sync(S + ti * 16 * kLdS + tj * 16, acc[t], kLdS,
                              wmma::mem_row_major);
    }
  }
};

// float32: thread (ty, tx) owns the 4x4 block rows ty*4.., keys tx*4..
struct FmaScores {
  float acc[4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(const float* Qs, const float* Ks, int) {
    constexpr int ld = Slice<float>::ld;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
    for (int d = 0; d < kDS; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx * 4 + j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* S, float scale, int) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[(ty * 4 + i) * kLdS + tx * 4 + j] = acc[i][j] * scale;
  }
};

template <typename T> struct ScoresFor { using type = FmaScores; };
template <> struct ScoresFor<__nv_bfloat16> { using type = TensorScores; };

// grid (Q, heads, n_chunks * n_row_tiles), block kThreads
template <typename T>
__global__ void __launch_bounds__(kThreads)
recompute_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const unsigned char* __restrict__ mask, T* __restrict__ out,
                 int H, int TQ, int dk, int B, int tt,
                 long long sq0, long long sq1, long long sq2,
                 long long sk0, long long sk1, long long sv0, long long sv1,
                 float scale, int n_chunks) {
  constexpr int ldq = Slice<T>::ld;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);          // [kRows][kLdS]
  float* Vs = S + kRows * kLdS;                           // [kKeys][kCols]
  float* mrow = Vs + kKeys * kCols;                       // [kRows]
  float* lrow = mrow + kRows;
  float* crow = lrow + kRows;
  T* Qs = reinterpret_cast<T*>(crow + kRows);             // [kRows][ldq]
  T* Ks = Qs + kRows * ldq;                               // [kKeys][ldq]

  const int qi = blockIdx.x, hh = blockIdx.y;
  const int chunk = blockIdx.z % n_chunks, rt = blockIdx.z / n_chunks;
  const int c0 = chunk * kCols, r0 = rt * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (long long)qi * sq0 + (long long)hh * sq1;
  const T* kb = k + (long long)hh * sk0;
  const T* vb = v + (long long)hh * sv0;

  for (int r = tid; r < kRows; r += kThreads) {
    mrow[r] = kNegInf;
    lrow[r] = 0.f;
  }
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e) acc[rr][e] = 0.f;
  typename ScoresFor<T>::type sc;

  for (int j = 0; j < B; ++j) {
    if (!mask[(long long)qi * B + j]) continue;          // uniform across the block
    for (int k0 = 0; k0 < tt; k0 += kKeys) {
      const int nk = min(kKeys, tt - k0);
      const long long key0 = (long long)j * tt + k0;
      // ---- scores over the full dk, in kDS-wide slices ----
      sc.zero();
      for (int d0 = 0; d0 < dk; d0 += kDS) {
        for (int i = tid; i < kRows * kDS; i += kThreads) {
          const int r = i / kDS, d = i - r * kDS;
          const int row = r0 + r, col = d0 + d;
          Qs[r * ldq + d] = (row < TQ && col < dk) ? qb[(long long)row * sq2 + col]
                                                   : zero_of<T>();
          Ks[r * ldq + d] = (r < nk && col < dk) ? kb[(key0 + r) * sk1 + col]
                                                 : zero_of<T>();
        }
        __syncthreads();
        sc.step(Qs, Ks, warp);
        __syncthreads();
      }
      sc.store(S, scale, warp);
      // ---- V tile (float32) for this block's columns ----
      for (int i = tid; i < kKeys * kCols; i += kThreads) {
        const int kk = i / kCols, c = i - kk * kCols;
        Vs[i] = (kk < nk && c0 + c < dk) ? to_f(vb[(key0 + kk) * sv1 + c0 + c]) : 0.f;
      }
      __syncthreads();
      // ---- online softmax: warp w owns rows w*8 .. w*8+7 ----
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        float* sr = S + r * kLdS;
        const bool v0 = lane < nk, v1 = lane + 32 < nk;
        const float s0 = v0 ? sr[lane] : -INFINITY;
        const float s1 = v1 ? sr[lane + 32] : -INFINITY;
        const float m_old = mrow[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float p0 = v0 ? expf(s0 - m_new) : 0.f;
        const float p1 = v1 ? expf(s1 - m_new) : 0.f;
        const float psum = warp_sum(p0 + p1);
        sr[lane] = p0;
        sr[lane + 32] = p1;
        __syncwarp();
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          crow[r] = corr;
          lrow[r] = lrow[r] * corr + psum;
          mrow[r] = m_new;
        }
      }
      __syncwarp();
      // ---- acc = acc * corr + p . v (rows of this warp, lane's columns) ----
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float corr = crow[warp * kRowsPerWarp + rr];
#pragma unroll
        for (int e = 0; e < kColsPerLane; ++e) acc[rr][e] *= corr;
      }
      for (int kk = 0; kk < nk; ++kk) {
        float vv[kColsPerLane];
#pragma unroll
        for (int e = 0; e < kColsPerLane; ++e) vv[e] = Vs[kk * kCols + lane + 32 * e];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float p = S[(warp * kRowsPerWarp + rr) * kLdS + kk];
#pragma unroll
          for (int e = 0; e < kColsPerLane; ++e) acc[rr][e] = fmaf(p, vv[e], acc[rr][e]);
        }
      }
      __syncthreads();   // S and Vs are rewritten by the next tile
    }
  }

  T* ob = out + ((long long)qi * H + hh) * (long long)TQ * dk;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, row = r0 + r;
    if (row >= TQ) continue;
    const float den = fmaxf(lrow[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e) {
      const int col = c0 + lane + 32 * e;
      if (col < dk) ob[(long long)row * dk + col] = from_f<T>(acc[rr][e] / den);
    }
  }
}

template <typename T>
int launch_recompute(const void* q, const void* k, const void* v, const void* mask, void* out,
                     int Q, int H, int TQ, int dk, int B, int tt, long long sq0,
                     long long sq1, long long sq2, long long sk0, long long sk1,
                     long long sv0, long long sv1, float scale, int smem_bytes,
                     cudaStream_t stream) {
  const size_t smem = recompute_smem_bytes<T>();
  if ((size_t)smem_bytes != smem) return -1;
  const int n_chunks = (dk + kCols - 1) / kCols;
  const int n_rows = (TQ + kRows - 1) / kRows;
  if ((long long)n_chunks * n_rows > 65535) return (int)cudaErrorInvalidValue;
  auto kern = recompute_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(Q, H, n_chunks * n_rows), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), H, TQ, dk, B, tt,
      sq0, sq1, sq2, sk0, sk1, sv0, sv1, scale, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// q [Q, H, TQ, dk] (strides sq0..sq2, last 1); k, v [H, B*tt, dk] (strides
// sk0/sk1, sv0/sv1, last 1); mask [Q, B] uint8 contiguous; out [Q, H, TQ, dk]
// contiguous. dtype: 0 = float32, 1 = bfloat16. route: 0 = recompute, 1 =
// cluster with `chunk` columns a block, `cluster` blocks, `key_tile` keys a
// tile and `warps` warps (launch_plan's choice; the cluster route needs
// 16-byte aligned rows). Returns cudaGetLastError() after the launch (0 =
// success), or -1 where the plan's shared-memory bytes or shape disagree with
// this file's.
extern "C" int fusion_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int Q, int H, int TQ,
                                       int dk, int B, int tt, long long sq0, long long sq1,
                                       long long sq2, long long sk0, long long sk1,
                                       long long sv0, long long sv1, float scale,
                                       int dtype, int route, int chunk, int cluster,
                                       int key_tile, int warps, int smem_bytes,
                                       void* stream) {
  if (Q < 1 || H < 1 || H > 65535 || TQ < 1 || dk < 1 || B < 1 || tt < 1)
    return (int)cudaErrorInvalidValue;
  if ((TQ + kRows - 1) / kRows > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FUSION_ARGS q, k, v, mask, out, Q, H, TQ, dk, B, tt, sq0, sq1, sq2, sk0, sk1, sv0, \
                    sv1, scale
  if (route == 0) {
    if (dtype == 0) return launch_recompute<float>(FUSION_ARGS, smem_bytes, st);
    if (dtype == 1) return launch_recompute<__nv_bfloat16>(FUSION_ARGS, smem_bytes, st);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 1 || cluster < 1 || cluster > 8 || (long long)Q * cluster > 2147483647LL)
    return (int)cudaErrorInvalidValue;
#define FUSION_CLUSTER(T, CH)                                                 \
  if (chunk == CH && key_tile == kKT && warps == kNW)                         \
    return launch_cluster<T, CH>(FUSION_ARGS, cluster, smem_bytes, st)
  if (dtype == 1) {
    FUSION_CLUSTER(__nv_bfloat16, 256);
    FUSION_CLUSTER(__nv_bfloat16, 128);
  } else if (dtype == 0) {
    FUSION_CLUSTER(float, 256);
    FUSION_CLUSTER(float, 128);
  }
#undef FUSION_CLUSTER
#undef FUSION_ARGS
  return -1;
}

#ifdef FUSION_PHASE_CLOCKS
// buf: [2][blocks][12] uint64 on the device (cycle counts, then nanoseconds),
// or NULL to stop stamping.
extern "C" int fusion_attention_phase_clocks(void* buf) {
  return (int)cudaMemcpyToSymbol(g_phase_clocks, &buf, sizeof(buf));
}
#endif
