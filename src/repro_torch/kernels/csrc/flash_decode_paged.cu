// flash_decode_paged for Hopper (sm_90a): single-query (decode) attention
// over a paged KV cache, out[bh] = softmax(q[bh] . K[r]^T * scale) V[r]
// over the live keys of pool row r = bh / groups, accumulated in f32, for
// float or bfloat16 q and pools (the output in the input's type).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_decode_paged (body _decode_kernel :77, pallas_call :161), the
// attention of a decode step.  The scores and the value sum are computed in
// this kernel's own body; no library call.
//
// Layouts: q [BH, hd]; k/v pools [BH / groups, P, ps, hd], contiguous;
// query row bh reads pool row bh / groups (grouped-query heads: groups
// query heads share one KV head, whose rows are never copied; groups = 1
// is the reference's one pool row a query row); the page table
// [n_logical] int32 maps logical page j (keys j*ps .. j*ps + ps - 1) to
// its physical slot, and is read from device memory.  window is a plain
// int argument (window < 0: none).  kv_len is an int argument, or, when
// kv_len_ptr is not null, the int32 that kv_len_ptr points to in device
// memory, read by every block at its start: the counterpart of the
// reference's traced scalar, so that one launch captured in a CUDA graph
// serves every position of a decode.  Both paths run the same code after
// that read and give the same bits.
//
// What it reads: only the live keys first .. kv_len - 1, first = kv_len -
// window (0 without a window), so only the logical pages lo .. hi - 1 of
// the reference (hi = ceil(kv_len / ps), lo = first floored to its page):
// a page past the live range is never touched and the table may hold
// anything there.  Every read is also clamped to the table (keys below
// n_logical * ps), so a device kv_len past the table reads no page past
// it, and a negative one reads nothing and writes zeros.  Positions inside
// a live page that are at or past kv_len or before the window are skipped
// before any load, which gives the same sums as the reference's NEG_INF
// scores (their exp is exactly 0).
//
// What bounds it on the H100: bytes.  Every live key and value row is read
// once a block and feeds 4 * hd flops a query row, far below the f32
// ridge of ~20 flop/byte (and bf16's ~295), so the least time is the live
// K/V bytes over 3.35 TB/s.  Two routes:
//  * per row (groups = 1, decode_kernel): one block a query row and split.
//    A decode step at OLMo-1B widths on 4 nodes gives a call 4 heads and up
//    to 512 keys (2 MB at most), so the time goes to latency unless many
//    SMs each keep many rows in flight.
//  * grouped (groups > 1, decode_grouped): one block a pool row (a KV head)
//    and split holds GR = 2 or 4 of its query rows (ceil(groups / GR)
//    blocks a pool row), so each live K/V row is fetched once for GR query
//    rows, not once a query row.  A lane copies its own 16-byte (or
//    4-byte) pieces of each round into a ring of S rounds in shared
//    memory with cp.async, S - 1 rounds ahead of its math (no block
//    barrier: a lane reads back only what it copied), converts each piece
//    to f32 once and applies it to the GR rows.  Each query row's
//    arithmetic is the per-row route's at the same splits, block width and
//    U (the same lanes, elements, xor trees, rounds and merge orders), so
//    a grouped call equals the per-row call on pools repeated groups times
//    bit for bit at the same launch shape.  That arithmetic, ~100
//    instructions a thread a round a row, makes a long grouped call bound
//    by issue rather than bytes (llama3-8b at 4096 keys: ~55% of the bytes
//    bound): its rows' chains run a phase at a time, two 8-warp blocks to
//    an SM, in one wave of clusters.  A call of one split (a short table)
//    writes its rows from the block, with no cluster merge.
// The design of both:
//  * Split-KV grid: the table's n_logical pages are cut into `splits`
//    contiguous runs of ceil(n_logical / splits) pages, chosen on the host
//    from the head count and the table's length, never from kv_len, so
//    one launch shape serves every position of a decode.  The grid is
//    splits x BH blocks (grouped: splits x rows x ceil(groups / GR)); the
//    splits of one block of query rows form one thread-block cluster (up
//    to 16 blocks, non-portable above 8).  A block whose run holds no live
//    key loads nothing and leaves an empty state (max NEG_INF, sum 0).
//  * Rows in flight: a block of 8 warps (runs of at most 64 keys) or 32
//    warps (longer runs, to keep more rows in flight on its SM; grouped
//    blocks are 8 warps, whose registers hold GR rows' state); each warp
//    takes U row groups a round.  A row is read by LPR lanes, 16 bytes a
//    lane (4 floats or 8 bfloat16) where a row is a whole number of 16-byte
//    pieces and both pools are 16-byte aligned, else one element a lane.
//    bfloat16 pieces stay packed in registers until the math converts each
//    element to f32.  The round's table entries are loaded first,
//    then all 2 * U row loads are issued before any of their math; the U
//    scores are reduced across the row's lanes together and feed one
//    online-softmax update a round, in base 2 (q is scaled by
//    scale * log2(e)), with the reference's initial max NEG_INF = -1e30,
//    so an empty run's correction is 0, never a NaN.
//  * The merge in the same launch: the warps' states (of each query row)
//    merge in shared memory in warp order into the block's (m, l,
//    acc[hd]), which every block writes into its own slot of the
//    cluster's rank 0 (distributed shared memory; the cluster barrier's
//    first phase, arrived at the kernel's start, guarantees rank 0 is
//    running).  After cluster.sync()
//    rank 0 merges the slots in split order, divides by max(l, 1e-30) and
//    writes the row.  Every sum runs in a fixed order and no atomics are
//    used, so two calls on the same inputs give the same bits, and one
//    launch is all a call takes (it can be captured in a CUDA graph).
//
// Build: see repro_torch/kernels/build.py.  Plain C interface; the entry
// point launches on the given stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// largest cluster the launch takes (above 8 it is non-portable)
constexpr int MAX_SPLITS = 16;
constexpr unsigned FULL = 0xffffffffu;
// the grouped route's block width and the most query rows (GR) a block
// holds: its blocks run two to an SM, at most 128 registers a thread (one
// on the 2-byte load route, whose eight loads a lane a row take more)
constexpr int GROUPED_WARPS = 8;
constexpr int MAX_GROUP_ROWS = 4;
// shared bytes of a grouped block's ring of rounds, at most
constexpr int RING_BYTES = 48 * 1024;
constexpr float NEG_INF = -1e30f;

// Shared memory of one block of `warps` warps, in 4-byte words: each warp's
// accumulator [warps][hd] and (m, l) [warps][2]; the cluster's blocks'
// accumulators [MAX_SPLITS][hd] and (m, l) [MAX_SPLITS][2], written by
// every block into rank 0's copy.
__host__ __device__ constexpr int smem_words(int hd, int warps) {
  return (warps + MAX_SPLITS) * (hd + 2);
}

// W elements of T read together: 16 bytes (one 128-bit load) or one element
template <typename T, int W>
struct alignas(sizeof(T) * W) Vec {
  T v[W];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int W>
__device__ __forceinline__ Vec<T, W> load_global(const T* p) {
  static_assert(W == 1 || sizeof(T) * W == 16, "one element or 16 bytes");
  Vec<T, W> r;
  if constexpr (W == 1) {
    r.v[0] = p[0];
  } else {
    *reinterpret_cast<uint4*>(r.v) = __ldg(reinterpret_cast<const uint4*>(p));
  }
  return r;
}

template <typename T, int W>
__device__ __forceinline__ Vec<T, W> zero_row() {
  Vec<T, W> r;
#pragma unroll
  for (int e = 0; e < W; ++e) r.v[e] = from_float<T>(0.f);
  return r;
}

// The weights of merging n <= 32 (m, l) states ml[2 i], ml[2 i + 1] in
// index order: returns lane i's weight and sets the merged max and sum.
// Called by every lane of a warp (lane i holds state i).
__device__ __forceinline__ float merge_weights(const float* ml, int n,
                                               float* m_out, float* l_out) {
  const int lane = threadIdx.x % 32;
  const float mi = lane < n ? ml[2 * lane] : NEG_INF;
  float mx = mi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  const float wi = lane < n ? exp2f(mi - mx) : 0.f;
  float l = lane < n ? ml[2 * lane + 1] * wi : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(FULL, l, off);
  *m_out = mx;
  *l_out = l;
  return wi;
}

// Element d of the merged accumulator: accs[i * stride + d] times lane i's
// weight wi, summed in index order.
__device__ __forceinline__ float merge_column(const float* accs, int stride,
                                              int n, int d, float wi) {
  float o = 0.f;
  for (int i = 0; i < n; ++i)
    o = fmaf(accs[i * stride + d], __shfl_sync(FULL, wi, i), o);
  return o;
}

// merge_column for CPW columns d[k] at once (a column at or past hd reads
// column hd - 1 and is not used): the sums interleave, each merge_column's.
template <int CPW>
__device__ __forceinline__ void merge_columns(const float* accs, int stride,
                                              int n, int hd,
                                              const int (&d)[CPW], float wi,
                                              float (&o)[CPW]) {
#pragma unroll
  for (int k = 0; k < CPW; ++k) o[k] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float w = __shfl_sync(FULL, wi, i);
#pragma unroll
    for (int k = 0; k < CPW; ++k)
      o[k] = fmaf(accs[i * stride + min(d[k], hd - 1)], w, o[k]);
  }
}

// Merge n <= 32 (m, l) states ml[2 i], ml[2 i + 1] and element d of their
// accumulators accs[i * stride + d], in index order.
__device__ __forceinline__ void merge_states(const float* ml,
                                             const float* accs, int stride,
                                             int n, int d, float* m_out,
                                             float* l_out, float* o_out) {
  *o_out = merge_column(accs, stride, n, d,
                        merge_weights(ml, n, m_out, l_out));
}

// One online-softmax update with the U row groups a lane has loaded; row
// group u is live while u * RPI < lim.
template <typename T, int W, int NC, int U, int LPR>
__device__ __forceinline__ void update(const float (&qr)[NC][W],
                                       const Vec<T, W> (&kr)[U][NC],
                                       const Vec<T, W> (&vr)[U][NC], int lim,
                                       float& m, float& l,
                                       float (&acc)[NC][W]) {
  constexpr int RPI = 32 / LPR;
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float t = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < W; ++e)
        t = fmaf(qr[c][e], to_float(kr[u][c].v[e]), t);
    s[u] = t;
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(FULL, s[u], off);
  float mx = m;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u * RPI < lim) mx = fmaxf(mx, s[u]);
  const float corr = exp2f(m - mx);
  l *= corr;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < W; ++e) acc[c][e] *= corr;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float p = u * RPI < lim ? exp2f(s[u] - mx) : 0.f;
    l += p;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < W; ++e)
        acc[c][e] = fmaf(p, to_float(vr[u][c].v[e]), acc[c][e]);
  }
  m = mx;
}

// NW warps a block; W elements of T a load, LPR lanes a row, NC loads a
// lane a row, U row groups a lane a round.  A lane holds the elements
// (sub + c * LPR) * W + e of its rows.
template <typename T, int NW, int W, int LPR, int NC, int U>
__global__ void __launch_bounds__(NW * 32, 1) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    T* __restrict__ out, int n_pages, int n_logical, int ps, int hd,
    int kv_len, const int* __restrict__ kv_len_ptr, int window, int groups,
    float scale) {
  constexpr int RPI = 32 / LPR;       // rows one load instruction covers
  constexpr int RPW = U * RPI;        // rows of a warp a round
  constexpr int RPB = NW * RPW;       // rows of the block a round
  extern __shared__ float smem[];
  float* s_acc = smem;                        // [NW][hd]
  float* s_ml = s_acc + NW * hd;              // [NW][2]
  float* c_acc = s_ml + 2 * NW;               // [MAX_SPLITS][hd]
  float* c_ml = c_acc + MAX_SPLITS * hd;      // [MAX_SPLITS][2]

  // Every block of the cluster must have started before another writes
  // into its shared memory: arrive now, wait just before those writes.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;
  const int split = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const long long pool = (long long)(bh / groups) * n_pages * ps * hd;

  // scores in base 2: q * scale * log2(e), so every exponential is exp2
  const float qscale = scale * 1.4426950408889634f;
  float qr[NC][W], acc[NC][W];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int d = (sub + c * LPR) * W + e;
      qr[c][e] = d < hd ? to_float(q[(long long)bh * hd + d]) * qscale : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  // this block's live keys k0 .. k1 - 1; a warp takes RPW of them a round
  if (kv_len_ptr != nullptr) kv_len = __ldg(kv_len_ptr);
  const int first = window < 0 ? 0 : max(0, kv_len - window);
  const int pps = (n_logical + splits - 1) / splits;
  const int k0 = max(first, split * pps * ps);
  const int k1 = min(kv_len, min(n_logical, (split + 1) * pps) * ps);
  for (int base = k0 + warp * RPW; base < k1; base += RPB) {
    const int lim = k1 - base - grp;
    // row base + u * RPI + grp is in-page row r of logical page lp
    int lp = (base + grp) / ps;
    int r = base + grp - lp * ps;
    int phys[U], rin[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rin[u] = r;
      phys[u] = u * RPI < lim ? __ldg(table + lp) : 0;
      for (r += RPI; r >= ps; r -= ps) ++lp;
    }
    Vec<T, W> kr[U][NC], vr[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = u * RPI < lim;
      const long long at = pool + ((long long)phys[u] * ps + rin[u]) * hd;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int e0 = (sub + c * LPR) * W;
        if (live && e0 < hd) {
          kr[u][c] = load_global<T, W>(kp + at + e0);
          vr[u][c] = load_global<T, W>(vp + at + e0);
        } else {
          kr[u][c] = zero_row<T, W>();
          vr[u][c] = zero_row<T, W>();
        }
      }
    }
    update<T, W, NC, U, LPR>(qr, kr, vr, lim, m, l, acc);
  }

  // the RPI row groups of a warp (LPR < 32), in a fixed xor tree
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(FULL, m, off);
    const float lo = __shfl_xor_sync(FULL, l, off);
    const float mx = fmaxf(m, mo);
    const float a = exp2f(m - mx), b = exp2f(mo - mx);
    l = l * a + lo * b;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[c][e], off);
        acc[c][e] = acc[c][e] * a + ao * b;
      }
    m = mx;
  }
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int d = (sub + c * LPR) * W + e;
        if (d < hd) s_acc[warp * hd + d] = acc[c][e];
      }
  }
  if (lane == 0) {
    s_ml[2 * warp] = m;
    s_ml[2 * warp + 1] = l;
  }
  __syncthreads();

  // the block's state, merged over its warps in warp order, goes into
  // slot `split` of rank 0's shared memory (distributed shared memory)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* r_acc = cluster.map_shared_rank(c_acc, 0);
  float* r_ml = cluster.map_shared_rank(c_ml, 0);
  for (int d0 = warp * 32; d0 < hd; d0 += NW * 32) {
    const int d = d0 + lane;
    float mb, lb, o;
    merge_states(s_ml, s_acc, hd, NW, min(d, hd - 1), &mb, &lb, &o);
    if (d < hd) r_acc[split * hd + d] = o;
    if (d == 0) {
      r_ml[2 * split] = mb;
      r_ml[2 * split + 1] = lb;
    }
  }
  cluster.sync();

  // rank 0: the cluster's blocks in rank order
  if (split == 0) {
    for (int d0 = warp * 32; d0 < hd; d0 += NW * 32) {
      const int d = d0 + lane;
      float mc, lc, o;
      merge_states(c_ml, c_acc, hd, splits, min(d, hd - 1), &mc, &lc, &o);
      if (d < hd)
        out[(long long)bh * hd + d] = from_float<T>(o / fmaxf(lc, 1e-30f));
    }
  }
}

// ---- the grouped route ----

// S, the rounds of K/V pieces a grouped block's ring holds: as many as its
// ring bytes take (2 to 6); one where a piece is a 2-byte element, which
// cp.async cannot copy (a plain load and store, so no round is ahead).
template <typename T, int NW, int W, int NC, int U>
__host__ __device__ constexpr int ring_stages() {
  constexpr int round = NW * 32 * U * NC * 2 * W * (int)sizeof(T);
  constexpr int fit = RING_BYTES / round;
  return sizeof(T) * W < 4 ? 1 : fit < 2 ? 2 : fit > 6 ? 6 : fit;
}

// The ring slots a grouped call uses: S, or fewer where a warp reads fewer
// rounds of its split (rpb rows a round).
__host__ __device__ inline int ring_slots(int stages, int n_logical, int ps,
                                          int splits, int rpb) {
  const int rounds = ((n_logical + splits - 1) / splits * ps + rpb - 1) / rpb;
  return rounds < stages ? rounds : stages;
}

// Shared memory of a grouped block, in 4-byte words: the ring's slots,
// which after the loop hold the warps' states [GR][NW][hd] and (m, l)
// [GR][NW][2]; then the cluster's slots [GR][splits][hd] and
// [GR][splits][2].
template <typename T, int NW, int W, int NC, int U>
__host__ __device__ constexpr int grouped_front(int hd, int gr, int slots) {
  return slots * NW * 32 * U * NC * 2 * ((W * (int)sizeof(T) + 3) / 4) >
                 gr * NW * (hd + 2)
             ? slots * NW * 32 * U * NC * 2 * ((W * (int)sizeof(T) + 3) / 4)
             : gr * NW * (hd + 2);
}

template <typename T, int NW, int W, int NC, int U>
__host__ __device__ constexpr int grouped_smem_words(int hd, int gr,
                                                     int slots, int splits) {
  return grouped_front<T, NW, W, NC, U>(hd, gr, slots) +
         gr * splits * (hd + 2);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One piece into the ring, or zeros where !ok (cp.async with source size
// 0 zero-fills; the source is then the pool's base, never read): 16 or 4
// bytes through cp.async, a 2-byte element by a plain load and store.
template <typename T, int W>
__device__ __forceinline__ void copy_piece(Vec<T, W>* dst, const T* src,
                                           const T* base, bool ok) {
  if constexpr (sizeof(T) * W == 16) {
    cp_async16(dst, ok ? src : base, ok ? 16 : 0);
  } else if constexpr (sizeof(T) * W == 4) {
    cp_async4(dst, ok ? src : base, ok ? 4 : 0);
  } else {
    *dst = ok ? load_global<T, W>(src) : zero_row<T, W>();
  }
}

// update() for GR query rows on the same f32 pieces, one phase at a time
// over all rows (the scores, the xor trees, the online-softmax updates), so
// the rows' chains overlap; each row's operations are update()'s in its
// order.  A block's idle rows (q 0) are updated too and never written.
template <int W, int NC, int U, int LPR, int GR>
__device__ __forceinline__ void update_rows(
    const float (&qr)[GR][NC][W], const Vec<float, W> (&kr)[U][NC],
    const Vec<float, W> (&vr)[U][NC], int lim, float (&m)[GR],
    float (&l)[GR], float (&acc)[GR][NC][W]) {
  constexpr int RPI = 32 / LPR;
  float s[GR][U];
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e) t = fmaf(qr[g][c][e], kr[u][c].v[e], t);
      s[g][u] = t;
    }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u)
        s[g][u] += __shfl_xor_sync(FULL, s[g][u], off);
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    float mx = m[g];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u * RPI < lim) mx = fmaxf(mx, s[g][u]);
    // update() rescales by exp2f(m - mx) every round; where the max did
    // not move that is exp2f(0) = 1, which changes no bit, so it is skipped
    // (update's l * corr is rounded before p is added, as here)
    if (mx != m[g]) {
      const float corr = exp2f(m[g] - mx);
      l[g] = __fmul_rn(l[g], corr);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[g][c][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = u * RPI < lim ? exp2f(s[g][u] - mx) : 0.f;
      l[g] += p;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e)
          acc[g][c][e] = fmaf(p, vr[u][c].v[e], acc[g][c][e]);
    }
    m[g] = mx;
  }
}

// The grouped route: block (split, y) takes pool row y / ceil(groups / GR)
// and query rows g0 .. g0 + nq - 1 of it, g0 = GR * (y % ceil(groups /
// GR)).  Every query row's sums are decode_kernel's at the same <NW, W,
// LPR, NC, U> and splits: `update`'s on the same lanes' f32 elements (the
// pieces converted once; to_float is exact), the same xor tree over a
// warp's row groups, and merge_states' weights and sums (merge_weights,
// merge_column) over the warps and then the splits.
template <typename T, int NW, int W, int LPR, int NC, int U, int GR>
__global__ void __launch_bounds__(NW * 32, sizeof(T) * W < 4 ? 1 : 2)
    decode_grouped(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    T* __restrict__ out, int n_pages, int n_logical, int ps, int hd,
    int kv_len, const int* __restrict__ kv_len_ptr, int window, int groups,
    float scale) {
  constexpr int RPI = 32 / LPR;       // rows one load instruction covers
  constexpr int RPW = U * RPI;        // rows of a warp a round
  constexpr int RPB = NW * RPW;       // rows of the block a round
  constexpr int S = ring_stages<T, NW, W, NC, U>();
  constexpr int PIECES = U * NC * 2 * NW * 32;   // a round's, a block's
  extern __shared__ __align__(16) float gsmem[];
  Vec<T, W>* ring = reinterpret_cast<Vec<T, W>*>(gsmem);
  const int splits = gridDim.x;
  float* s_acc = gsmem;                         // [GR][NW][hd], after
  float* s_ml = s_acc + GR * NW * hd;           // [GR][NW][2], the loop
  float* c_acc = gsmem + grouped_front<T, NW, W, NC, U>(
                             hd, GR, ring_slots(S, n_logical, ps, splits, RPB));
  float* c_ml = c_acc + GR * splits * hd;       // [GR][splits][2]

  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int per_row = (groups + GR - 1) / GR;
  const int prow = blockIdx.y / per_row;
  const int g0 = (blockIdx.y - prow * per_row) * GR;
  const int nq = min(GR, groups - g0);
  const long long qrow = (long long)prow * groups + g0;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const long long pool = (long long)prow * n_pages * ps * hd;

  float qr[GR][NC][W], acc[GR][NC][W], m[GR], l[GR];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][c][e] = 0.f;
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  if (kv_len_ptr != nullptr) kv_len = __ldg(kv_len_ptr);
  const int first = window < 0 ? 0 : max(0, kv_len - window);
  const int pps = (n_logical + splits - 1) / splits;
  const int k0 = max(first, split * pps * ps);
  const int k1 = min(kv_len, min(n_logical, (split + 1) * pps) * ps);
  // this warp's rounds: rows start + j * RPB .. + RPW - 1
  const int start = k0 + warp * RPW;
  const int rounds = start < k1 ? (k1 - start + RPB - 1) / RPB : 0;

  // round j's pieces (this lane's) into ring slot j % S, one commit group
  // a round whether or not it has pieces; called for j = 0, 1, ... in
  // order, which steps the logical page lp0 and in-page row r0 of the
  // lane's first row from round to round
  const int step_lp = RPB / ps, step_r = RPB - step_lp * ps;
  int lp0 = (start + grp) / ps;
  int r0 = start + grp - lp0 * ps;
  auto issue = [&](int j) {
    if (j < rounds) {
      Vec<T, W>* slot = ring + (j % S) * PIECES + tid;
      const int lim = k1 - (start + j * RPB) - grp;
      int lp = lp0, r = r0;
      lp0 += step_lp;
      r0 += step_r;
      if (r0 >= ps) {
        r0 -= ps;
        ++lp0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool live = u * RPI < lim;
        const int phys = live ? __ldg(table + lp) : 0;
        const long long at = pool + ((long long)phys * ps + r) * hd;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int e0 = (sub + c * LPR) * W;
          const bool ok = live && e0 < hd;
          copy_piece<T, W>(slot + ((u * NC + c) * 2) * NW * 32,
                           kp + at + e0, kp, ok);
          copy_piece<T, W>(slot + ((u * NC + c) * 2 + 1) * NW * 32,
                           vp + at + e0, vp, ok);
        }
        for (r += RPI; r >= ps; r -= ps) ++lp;
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int j = 0; j < S - 1; ++j) issue(j);
  // the query rows, loaded once the first rounds' copies are in flight:
  // 16 bytes at a time where q is 16-byte aligned, else an element at a
  // time, every load from an address inside q (an idle row or column
  // reads row 0 or column 0, then counts as 0)
  const float qscale = scale * 1.4426950408889634f;
  const bool qvec = W * sizeof(T) == 16 && (uintptr_t)q % 16 == 0;
#pragma unroll
  for (int g = 0; g < GR; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e0 = (sub + c * LPR) * W;
      const T* row = q + (qrow + (g < nq ? g : 0)) * hd;
      Vec<T, W> x;
      if (qvec) {
        x = *reinterpret_cast<const Vec<T, W>*>(row + (e0 < hd ? e0 : 0));
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) x.v[e] = row[e0 + e < hd ? e0 + e : 0];
      }
#pragma unroll
      for (int e = 0; e < W; ++e)
        qr[g][c][e] =
            g < nq && e0 + e < hd ? to_float(x.v[e]) * qscale : 0.f;
    }
  }
  for (int j = 0; j < rounds; ++j) {
    issue(j + S - 1);
    cp_async_wait<S - 1>();
    const Vec<T, W>* slot = ring + (j % S) * PIECES + tid;
    Vec<float, W> kf[U][NC], vf[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const Vec<T, W> kx = slot[((u * NC + c) * 2) * NW * 32];
        const Vec<T, W> vx = slot[((u * NC + c) * 2 + 1) * NW * 32];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          kf[u][c].v[e] = to_float(kx.v[e]);
          vf[u][c].v[e] = to_float(vx.v[e]);
        }
      }
    }
    const int lim = k1 - (start + j * RPB) - grp;
    update_rows<W, NC, U, LPR, GR>(qr, kf, vf, lim, m, l, acc);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is read out; it becomes the warps' states

  // the RPI row groups of a warp (LPR < 32), in a fixed xor tree, a level
  // at a time over all rows.  decode_kernel's `l * a + lo * b` compiles to
  // fmaf(l, a, lo * b) (nvcc contracts the first product); that form is
  // written out here, so the compiler cannot contract these sums otherwise
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lo = __shfl_xor_sync(FULL, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mx), b = exp2f(mo - mx);
      l[g] = fmaf(l[g], a, __fmul_rn(lo, b));
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float ao = __shfl_xor_sync(FULL, acc[g][c][e], off);
          acc[g][c][e] = fmaf(acc[g][c][e], a, __fmul_rn(ao, b));
        }
      m[g] = mx;
    }
  }
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    if (g >= nq) break;
    if (grp == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int d = (sub + c * LPR) * W + e;
          if (d < hd) s_acc[(g * NW + warp) * hd + d] = acc[g][c][e];
        }
    }
    if (lane == 0) {
      s_ml[2 * (g * NW + warp)] = m[g];
      s_ml[2 * (g * NW + warp) + 1] = l[g];
    }
  }
  __syncthreads();

  // each query row's state, merged over the warps in warp order: NW / nq
  // warps take a row, each its weights once and then its 32-column chunks
  // (at most CPW) together.  One split: that is the row (merging one state
  // is exact: its weight is exp2f(0) = 1), written here.  More: it goes
  // into slot (g, split) of rank 0's shared memory.
  constexpr int CPW = (LPR * NC * W / 32 + NW / GR - 1) / (NW / GR);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* r_acc = cluster.map_shared_rank(c_acc, 0);
  float* r_ml = cluster.map_shared_rank(c_ml, 0);
  const int wpr = NW / nq;
  const int g = warp / wpr;
  int d[CPW];
#pragma unroll
  for (int k = 0; k < CPW; ++k)
    d[k] = (warp - g * wpr + k * wpr) * 32 + lane;
  float o[CPW];
  if (g < nq) {
    float mb, lb;
    const float wi = merge_weights(s_ml + 2 * g * NW, NW, &mb, &lb);
    merge_columns<CPW>(s_acc + g * NW * hd, hd, NW, hd, d, wi, o);
    const int at = g * splits + split;
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      if (d[k] >= hd) break;
      if (splits == 1)
        out[(qrow + g) * hd + d[k]] =
            from_float<T>(o[k] / fmaxf(lb, 1e-30f));
      else
        r_acc[at * hd + d[k]] = o[k];
    }
    if (lane == 0 && warp == g * wpr) {
      r_ml[2 * at] = mb;
      r_ml[2 * at + 1] = lb;
    }
  }
  if (splits == 1) return;
  cluster.sync();

  // rank 0: each query row over the cluster's blocks in rank order
  if (split == 0 && g < nq) {
    float mc, lc;
    const float wi =
        merge_weights(c_ml + 2 * g * splits, splits, &mc, &lc);
    merge_columns<CPW>(c_acc + g * splits * hd, hd, splits, hd, d, wi,
                       o);
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      if (d[k] >= hd) break;
      out[(qrow + g) * hd + d[k]] =
          from_float<T>(o[k] / fmaxf(lc, 1e-30f));
    }
  }
}

// splits x `blocks` blocks of `warps` warps (blocks: bh query rows, or
// rows x ceil(groups / GR) grouped blocks), the splits of one block of
// query rows one cluster
cudaLaunchConfig_t launch_config(int blocks, int splits, int warps,
                                 int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, blocks, 1);
  cfg.blockDim = dim3(warps * 32, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int*, T*, int,
                        int, int, int, int, const int*, int, int, float);

// An instance, its shared bytes at a head dim and the rows one of its
// blocks reads a round.
template <typename T>
struct Instance {
  Kernel<T> kernel;
  int smem_bytes;
  int rows_a_round;
};

// What a call's shared memory depends on beyond the instance.
struct Call {
  int hd, splits, n_logical, ps;
};

// Once per instance: room for the shared bytes of its largest head dim
// (above the default 48 KB at hd 256 with 32 warps, and for every grouped
// ring), and clusters above the portable 8.
template <typename T>
cudaError_t set_attributes(Kernel<T> kernel, int max_smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// The per-row route's instances (decode_kernel) ...
struct PerRow {
  template <typename T, int NW, int W, int LPR, int NC, int U>
  static cudaError_t prepare(const Call& call, Instance<T>* inst) {
    inst->kernel = decode_kernel<T, NW, W, LPR, NC, U>;
    inst->smem_bytes = smem_words(call.hd, NW) * 4;
    inst->rows_a_round = NW * U * (32 / LPR);
    static bool ready = false;
    if (!ready) {
      const cudaError_t e =
          set_attributes<T>(inst->kernel, smem_words(LPR * NC * W, NW) * 4);
      if (e != cudaSuccess) return e;
      ready = true;
    }
    return cudaSuccess;
  }
};

// ... and the grouped route's (decode_grouped), GR query rows a block.
template <int GR>
struct Grouped {
  template <typename T, int NW, int W, int LPR, int NC, int U>
  static cudaError_t prepare(const Call& call, Instance<T>* inst) {
    constexpr int S = ring_stages<T, NW, W, NC, U>();
    constexpr int RPB = NW * U * (32 / LPR);
    inst->kernel = decode_grouped<T, NW, W, LPR, NC, U, GR>;
    inst->smem_bytes =
        grouped_smem_words<T, NW, W, NC, U>(
            call.hd, GR,
            ring_slots(S, call.n_logical, call.ps, call.splits, RPB),
            call.splits) *
        4;
    inst->rows_a_round = RPB;
    static bool ready = false;
    if (!ready) {
      const cudaError_t e = set_attributes<T>(
          inst->kernel, grouped_smem_words<T, NW, W, NC, U>(
                            LPR * NC * W, GR, S, MAX_SPLITS) *
                            4);
      if (e != cudaSuccess) return e;
      ready = true;
    }
    return cudaSuccess;
  }
};

// The f32 instance of a block width, head dim and load width.  16-byte
// loads (vec) take LPR = hd / 4 lanes a row rounded up to 8, 16 or 32, and
// two loads a lane above hd 128; 4-byte loads take 32 lanes a row and
// ceil(hd / 32) loads a lane.  U, the row groups a lane loads a round, is
// 4 in an 8-warp block and 2 in a 32-warp block (held to 64 registers a
// thread), halved where a lane holds two 16-byte pieces of a row (hd 256)
// and doubled where it holds at most two floats (4-byte loads, hd <= 64).
// Both routes take the same table, so a grouped block's rows are the
// 8-warp per-row block's.
template <int NW, typename R>
cudaError_t pick_width(const Call& call, int vec, Instance<float>* inst) {
  const int hd = call.hd;
  constexpr int U = NW == 8 ? 4 : 2;
  if (vec) {
    if (hd <= 32) return R::template prepare<float, NW, 4, 8, 1, U>(call, inst);
    if (hd <= 64)
      return R::template prepare<float, NW, 4, 16, 1, U>(call, inst);
    if (hd <= 128)
      return R::template prepare<float, NW, 4, 32, 1, U>(call, inst);
    return R::template prepare<float, NW, 4, 32, 2, U / 2>(call, inst);
  }
  if (hd <= 32)
    return R::template prepare<float, NW, 1, 32, 1, 2 * U>(call, inst);
  if (hd <= 64)
    return R::template prepare<float, NW, 1, 32, 2, 2 * U>(call, inst);
  if (hd <= 128) return R::template prepare<float, NW, 1, 32, 4, U>(call, inst);
  return R::template prepare<float, NW, 1, 32, 8, U / 2>(call, inst);
}

// The bf16 instance: 16-byte loads hold 8 elements, so LPR = hd / 8 lanes a
// row rounded up to 4, 16 or 32 (one load a lane up to hd 256) and a warp
// covers 32 / LPR rows a load; U is half the f32 one, which keeps the rows
// a warp has in flight at hd 128 equal to the f32 kernel's (8 lanes' f32
// registers hold each lane's 8 converted query and accumulator elements).
// 2-byte loads take the f32 table's lanes and loads.
template <int NW, typename R>
cudaError_t pick_width(const Call& call, int vec,
                       Instance<__nv_bfloat16>* inst) {
  using B = __nv_bfloat16;
  const int hd = call.hd;
  constexpr int U = NW == 8 ? 4 : 2;
  if (vec) {
    if (hd <= 32) return R::template prepare<B, NW, 8, 4, 1, U / 2>(call, inst);
    if (hd <= 64) return R::template prepare<B, NW, 8, 8, 1, U / 2>(call, inst);
    if (hd <= 128)
      return R::template prepare<B, NW, 8, 16, 1, U / 2>(call, inst);
    return R::template prepare<B, NW, 8, 32, 1, U / 2>(call, inst);
  }
  if (hd <= 32) return R::template prepare<B, NW, 1, 32, 1, 2 * U>(call, inst);
  if (hd <= 64) return R::template prepare<B, NW, 1, 32, 2, 2 * U>(call, inst);
  if (hd <= 128) return R::template prepare<B, NW, 1, 32, 4, U>(call, inst);
  return R::template prepare<B, NW, 1, 32, 8, U / 2>(call, inst);
}

// gr 1: the per-row route at `warps`; gr 2 or 4: the grouped route
template <typename T>
cudaError_t pick(const Call& call, int vec, int warps, int gr,
                 Instance<T>* inst) {
  switch (gr) {
    case 1:
      return warps == 8 ? pick_width<8, PerRow>(call, vec, inst)
                        : pick_width<32, PerRow>(call, vec, inst);
    case 2:
      return pick_width<GROUPED_WARPS, Grouped<2>>(call, vec, inst);
    case MAX_GROUP_ROWS:
      return pick_width<GROUPED_WARPS, Grouped<MAX_GROUP_ROWS>>(call, vec,
                                                                inst);
    default:
      return cudaErrorInvalidValue;
  }
}

// vec needs rows of whole 16-byte pieces and 16-byte aligned pools; gr is
// 1 for groups = 1 and a grouped instance's (2 or 4, in blocks of
// GROUPED_WARPS) for groups > 1: a grouped call never takes the per-row
// route
cudaError_t check_call(int bh, int hd, int vec, int splits, int warps,
                       int groups, int gr, int esize, const void* kp,
                       const void* vp) {
  if (hd < 1 || hd > 256 || bh < 1 || bh > 65535 || splits < 1 ||
      splits > MAX_SPLITS || (warps != 8 && warps != 32) || groups < 1 ||
      bh % groups != 0)
    return cudaErrorInvalidValue;
  if (groups == 1 ? gr != 1
                  : (gr != 2 && gr != MAX_GROUP_ROWS) ||
                        warps != GROUPED_WARPS)
    return cudaErrorInvalidValue;
  if (vec && ((hd * esize) % 16 != 0 || (uintptr_t)kp % 16 != 0 ||
              (uintptr_t)vp % 16 != 0))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// blocks of query rows: one a query row, or ceil(groups / gr) a pool row
int query_blocks(int bh, int groups, int gr) {
  return gr == 1 ? bh : bh / groups * ((groups + gr - 1) / gr);
}

template <typename T>
int launch(const T* q, const T* kp, const T* vp, const int* table, T* out,
           int bh, int n_pages, int n_logical, int ps, int hd, int kv_len,
           const int* kv_len_ptr, int window, int splits, int warps, int vec,
           int groups, int gr, float scale, void* stream) {
  cudaError_t e = check_call(bh, hd, vec, splits, warps, groups, gr,
                             (int)sizeof(T), kp, vp);
  if (e != cudaSuccess) return (int)e;
  Instance<T> inst;
  e = pick(Call{hd, splits, n_logical, ps}, vec, warps, gr, &inst);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(query_blocks(bh, groups, gr), splits, warps,
                    inst.smem_bytes, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, inst.kernel, q, kp, vp, table, out, n_pages,
                         n_logical, ps, hd, kv_len, kv_len_ptr, window,
                         groups, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shape of a call: info = {threads a block, dynamic shared
// bytes, clusters the card holds at once, rows a block reads a round}.
template <typename T>
int occupancy(int bh, int hd, int vec, int splits, int warps, int groups,
              int gr, int n_logical, int ps, int* info) {
  cudaError_t e = check_call(bh, hd, vec, splits, warps, groups, gr,
                             (int)sizeof(T), nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (n_logical < 1 || ps < 1) return (int)cudaErrorInvalidValue;
  Instance<T> inst;
  e = pick(Call{hd, splits, n_logical, ps}, vec, warps, gr, &inst);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(query_blocks(bh, groups, gr), splits, warps,
                    inst.smem_bytes, nullptr, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, inst.kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  info[0] = warps * 32;
  info[1] = inst.smem_bytes;
  info[2] = clusters;
  info[3] = inst.rows_a_round;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_paged_f32(const float* q, const float* kp,
                                      const float* vp, const int* table,
                                      float* out, int bh, int n_pages,
                                      int n_logical, int ps, int hd,
                                      int kv_len, const int* kv_len_ptr,
                                      int window, int splits, int warps,
                                      int vec, int groups, int gr,
                                      float scale, void* stream) {
  return launch(q, kp, vp, table, out, bh, n_pages, n_logical, ps, hd,
                kv_len, kv_len_ptr, window, splits, warps, vec, groups, gr,
                scale, stream);
}

extern "C" int flash_decode_paged_bf16(const __nv_bfloat16* q,
                                       const __nv_bfloat16* kp,
                                       const __nv_bfloat16* vp,
                                       const int* table, __nv_bfloat16* out,
                                       int bh, int n_pages, int n_logical,
                                       int ps, int hd, int kv_len,
                                       const int* kv_len_ptr, int window,
                                       int splits, int warps, int vec,
                                       int groups, int gr, float scale,
                                       void* stream) {
  return launch(q, kp, vp, table, out, bh, n_pages, n_logical, ps, hd,
                kv_len, kv_len_ptr, window, splits, warps, vec, groups, gr,
                scale, stream);
}

extern "C" int flash_decode_paged_occupancy(int bh, int hd, int vec,
                                            int splits, int warps,
                                            int groups, int gr,
                                            int n_logical, int ps,
                                            int* info) {
  return occupancy<float>(bh, hd, vec, splits, warps, groups, gr, n_logical,
                          ps, info);
}

extern "C" int flash_decode_paged_occupancy_bf16(int bh, int hd, int vec,
                                                 int splits, int warps,
                                                 int groups, int gr,
                                                 int n_logical, int ps,
                                                 int* info) {
  return occupancy<__nv_bfloat16>(bh, hd, vec, splits, warps, groups, gr,
                                  n_logical, ps, info);
}
