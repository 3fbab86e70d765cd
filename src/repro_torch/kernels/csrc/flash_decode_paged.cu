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
// query row bh reads pool row bh / groups (grouped-query heads by index:
// groups query heads share one KV head, whose rows are read by each of
// their blocks, never copied; groups = 1 is the reference's one pool row a
// query row); the page table [n_logical] int32 maps logical page j (keys
// j*ps .. j*ps + ps - 1) to its physical slot, and is read from device
// memory.  window is a plain
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
// once and feeds 4 * hd flops a query row, far below the f32 ridge of ~20
// flop/byte (and bf16's ~295), so the least time is the live K/V bytes
// over 3.35 TB/s.  With groups > 1 each query row is its own block, so a
// KV head's rows are fetched once a query row; the repeats mostly hit L2,
// and merging a head's query rows into one block is later work.  A decode step
// at OLMo-1B widths on 4 nodes gives a call 4 heads and up to 512 keys
// (2 MB at most), so the time goes to latency unless many SMs each keep
// many rows in flight.  The design:
//  * Split-KV grid: the table's n_logical pages are cut into `splits`
//    contiguous runs of ceil(n_logical / splits) pages, chosen on the host
//    from the head count and the table's length, never from kv_len, so
//    one launch shape serves every position of a decode.  The grid is
//    splits x BH blocks; the splits of one head form one thread-block
//    cluster (up to 16 blocks, non-portable above 8).  A block whose run
//    holds no live key loads nothing and leaves an empty state (max
//    NEG_INF, sum 0).
//  * Rows in flight: a block of 8 warps (runs of at most 64 keys) or 32
//    warps (longer runs, to keep more rows in flight on its SM); each warp
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
//  * The merge in the same launch: the warps' states merge in shared
//    memory in warp order into the block's (m, l, acc[hd]), which every
//    block writes into its own slot of the cluster's rank 0 (distributed
//    shared memory; the cluster barrier's first phase, arrived at the
//    kernel's start, guarantees rank 0 is running).  After cluster.sync()
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

// Merge n <= 32 (m, l) states ml[2 i], ml[2 i + 1] and element d of their
// accumulators accs[i * stride + d], in index order.  Called by every lane
// of a warp (lane i holds state i while the weights are formed).
__device__ __forceinline__ void merge_states(const float* ml,
                                             const float* accs, int stride,
                                             int n, int d, float* m_out,
                                             float* l_out, float* o_out) {
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
  float o = 0.f;
  for (int i = 0; i < n; ++i)
    o = fmaf(accs[i * stride + d], __shfl_sync(FULL, wi, i), o);
  *m_out = mx;
  *l_out = l;
  *o_out = o;
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

// splits x bh blocks of `warps` warps, the splits of one head one cluster
cudaLaunchConfig_t launch_config(int bh, int splits, int warps,
                                 int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, bh, 1);
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

template <typename T, int NW, int W, int LPR, int NC, int U>
cudaError_t prepare(int hd, Instance<T>* inst) {
  inst->kernel = decode_kernel<T, NW, W, LPR, NC, U>;
  inst->smem_bytes = smem_words(hd, NW) * 4;
  inst->rows_a_round = NW * U * (32 / LPR);
  // once per instance: room for the shared bytes of its largest head dim
  // (above the default 48 KB at hd 256 with 32 warps), and clusters above
  // the portable 8
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        inst->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_words(LPR * NC * W, NW) * 4);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          inst->kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  return cudaSuccess;
}

// The f32 instance of a block width, head dim and load width.  16-byte
// loads (vec) take LPR = hd / 4 lanes a row rounded up to 8, 16 or 32, and
// two loads a lane above hd 128; 4-byte loads take 32 lanes a row and
// ceil(hd / 32) loads a lane.  U, the row groups a lane loads a round, is
// 4 in an 8-warp block and 2 in a 32-warp block (held to 64 registers a
// thread), halved where a lane holds two 16-byte pieces of a row (hd 256)
// and doubled where it holds at most two floats (4-byte loads, hd <= 64).
template <int NW>
cudaError_t pick_width(int hd, int vec, Instance<float>* inst) {
  constexpr int U = NW == 8 ? 4 : 2;
  if (vec) {
    if (hd <= 32) return prepare<float, NW, 4, 8, 1, U>(hd, inst);
    if (hd <= 64) return prepare<float, NW, 4, 16, 1, U>(hd, inst);
    if (hd <= 128) return prepare<float, NW, 4, 32, 1, U>(hd, inst);
    return prepare<float, NW, 4, 32, 2, U / 2>(hd, inst);
  }
  if (hd <= 32) return prepare<float, NW, 1, 32, 1, 2 * U>(hd, inst);
  if (hd <= 64) return prepare<float, NW, 1, 32, 2, 2 * U>(hd, inst);
  if (hd <= 128) return prepare<float, NW, 1, 32, 4, U>(hd, inst);
  return prepare<float, NW, 1, 32, 8, U / 2>(hd, inst);
}

// The bf16 instance: 16-byte loads hold 8 elements, so LPR = hd / 8 lanes a
// row rounded up to 4, 16 or 32 (one load a lane up to hd 256) and a warp
// covers 32 / LPR rows a load; U is half the f32 one, which keeps the rows
// a warp has in flight at hd 128 equal to the f32 kernel's (8 lanes' f32
// registers hold each lane's 8 converted query and accumulator elements).
// 2-byte loads take the f32 table's lanes and loads.
template <int NW>
cudaError_t pick_width(int hd, int vec, Instance<__nv_bfloat16>* inst) {
  using B = __nv_bfloat16;
  constexpr int U = NW == 8 ? 4 : 2;
  if (vec) {
    if (hd <= 32) return prepare<B, NW, 8, 4, 1, U / 2>(hd, inst);
    if (hd <= 64) return prepare<B, NW, 8, 8, 1, U / 2>(hd, inst);
    if (hd <= 128) return prepare<B, NW, 8, 16, 1, U / 2>(hd, inst);
    return prepare<B, NW, 8, 32, 1, U / 2>(hd, inst);
  }
  if (hd <= 32) return prepare<B, NW, 1, 32, 1, 2 * U>(hd, inst);
  if (hd <= 64) return prepare<B, NW, 1, 32, 2, 2 * U>(hd, inst);
  if (hd <= 128) return prepare<B, NW, 1, 32, 4, U>(hd, inst);
  return prepare<B, NW, 1, 32, 8, U / 2>(hd, inst);
}

template <typename T>
cudaError_t pick(int hd, int vec, int warps, Instance<T>* inst) {
  return warps == 8 ? pick_width<8>(hd, vec, inst)
                    : pick_width<32>(hd, vec, inst);
}

// vec needs rows of whole 16-byte pieces and 16-byte aligned pools
cudaError_t check_call(int bh, int hd, int vec, int splits, int warps,
                       int groups, int esize, const void* kp,
                       const void* vp) {
  if (hd < 1 || hd > 256 || bh < 1 || bh > 65535 || splits < 1 ||
      splits > MAX_SPLITS || (warps != 8 && warps != 32) || groups < 1 ||
      bh % groups != 0)
    return cudaErrorInvalidValue;
  if (vec && ((hd * esize) % 16 != 0 || (uintptr_t)kp % 16 != 0 ||
              (uintptr_t)vp % 16 != 0))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
int launch(const T* q, const T* kp, const T* vp, const int* table, T* out,
           int bh, int n_pages, int n_logical, int ps, int hd, int kv_len,
           const int* kv_len_ptr, int window, int splits, int warps, int vec,
           int groups, float scale, void* stream) {
  cudaError_t e = check_call(bh, hd, vec, splits, warps, groups,
                             (int)sizeof(T), kp, vp);
  if (e != cudaSuccess) return (int)e;
  Instance<T> inst;
  e = pick(hd, vec, warps, &inst);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(
      bh, splits, warps, inst.smem_bytes, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, inst.kernel, q, kp, vp, table, out, n_pages,
                         n_logical, ps, hd, kv_len, kv_len_ptr, window,
                         groups, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shape of a call: info = {threads a block, dynamic shared
// bytes, clusters the card holds at once, rows a block reads a round}.
template <typename T>
int occupancy(int bh, int hd, int vec, int splits, int warps, int* info) {
  cudaError_t e = check_call(bh, hd, vec, splits, warps, 1, (int)sizeof(T),
                             nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  Instance<T> inst;
  e = pick(hd, vec, warps, &inst);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(bh, splits, warps, inst.smem_bytes, nullptr, attr);
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
                                      int vec, int groups, float scale,
                                      void* stream) {
  return launch(q, kp, vp, table, out, bh, n_pages, n_logical, ps, hd,
                kv_len, kv_len_ptr, window, splits, warps, vec, groups, scale,
                stream);
}

extern "C" int flash_decode_paged_bf16(const __nv_bfloat16* q,
                                       const __nv_bfloat16* kp,
                                       const __nv_bfloat16* vp,
                                       const int* table, __nv_bfloat16* out,
                                       int bh, int n_pages, int n_logical,
                                       int ps, int hd, int kv_len,
                                       const int* kv_len_ptr, int window,
                                       int splits, int warps, int vec,
                                       int groups, float scale,
                                       void* stream) {
  return launch(q, kp, vp, table, out, bh, n_pages, n_logical, ps, hd,
                kv_len, kv_len_ptr, window, splits, warps, vec, groups, scale,
                stream);
}

extern "C" int flash_decode_paged_occupancy(int bh, int hd, int vec,
                                            int splits, int warps,
                                            int* info) {
  return occupancy<float>(bh, hd, vec, splits, warps, info);
}

extern "C" int flash_decode_paged_occupancy_bf16(int bh, int hd, int vec,
                                                 int splits, int warps,
                                                 int* info) {
  return occupancy<__nv_bfloat16>(bh, hd, vec, splits, warps, info);
}
