// flash_attention_bh for Hopper (sm_90a): causal and/or sliding-window
// attention out = softmax(mask(q k^T * scale)) v, streamed over key tiles
// with the online softmax, f32 accumulation, f32 or bf16 in and out, both
// products on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bh (body _flash_kernel :28, pallas_call :183) and the
// head repeat and sequence padding of its wrapper src/repro/kernels/ops.py::
// flash_attention (:27).  Both products (q k^T and p v) are computed in this
// kernel's own body: no library GEMM and no fused library attention.
//
// Layouts: q and out [B, H, S, hd], k and v [B, KV, S, hd], contiguous,
// H % KV == 0.  GQA is an index: query head h reads kv head h / (H / KV);
// no repeated copy of k and v exists.  Any S: keys at or past S are masked
// and query rows at or past S are not stored, so nothing is padded (the
// reference's wrapper pads S with zero keys that its non-causal kernel
// does not mask).  Given an lse pointer, it also writes f32 [B, H, S], each
// row's log-sum-exp m + log(l) of its masked scale q k scores in natural-log
// units (the reference's _flash_fwd keeps it for its backward,
// src/repro/models/attention.py:156-162); a null pointer writes nothing
// more and leaves the output's bits as they were.
// Masked scores are the finite NEG_INF = -1e30, so a tile
// with every key masked contributes 0 and never a NaN.  Any hd from 1 to
// 256: the instance of the next head dim in 32, 64, 96, 128, 192, 256
// takes it, its shared tiles zero past hd.
//
// What bounds it on the H100: operations.  A causal head at S = 2048,
// hd = 128 does ~1.1 GFLOP against 4 MB of q/k/v/out in f32.
//  * bf16: the tensor cores' 989 TFLOP/s.  Both products are
//    mma.sync.m16n8k16 with f32 accumulators in registers (q and k
//    fragments by ldmatrix, v by ldmatrix.trans); the score tile stays in
//    registers and becomes, rounded to bf16, the A operand of p v (the
//    accumulator layout of q k^T is the A layout of p v), so it never goes
//    through shared memory.  Tolerance 2e-2 of scale, the reference's bf16
//    tolerance.
//  * f32: the reference's 1e-4 of scale rules out plain TF32 (about three
//    digits).  Each operand is split into a TF32 high part
//    (cvt.rna.tf32.f32) and the f32 residual, and each product is
//    lo*hi + hi*lo + hi*hi on mma.sync.m16n8k8.tf32 (3xTF32, ~f32
//    accuracy; the small terms of q k^T in their own accumulator), so the
//    rate that bounds it is 495 / 3 = 165 TFLOP/s.  The depth index of each
//    8-wide step is permuted (logical t, t + 4 -> physical 2t, 2t + 1), the
//    same in both operands, so q and k fragments are 8-byte loads and the
//    score accumulator feeds p v without a shuffle.
// Design: a block of 4 warps takes BQ = 64 MT query rows of one b*h; each
// warp owns MT 16-row m-tiles, their online max and sum and their output
// accumulator, all in registers.  Two m-tiles a warp use every k and v
// fragment twice: bf16 takes two up to hd 128; f32 up to hd 64, and at hd
// 65-128 when the call is non-causal or its grid fills two waves of the
// card (the causal diagonal's blocks read every key: fewer, longer blocks
// leave the last wave unbalanced).  exp2 is one MUFU instruction with
// scale * log2(e) as one multiply; the sum is taken across the row's four
// lanes once, at the end, and divided with the same max(l, 1e-30) guard;
// the accumulator is rescaled only when some row maximum of the warp moved.
// The q tile is copied once; k and v tiles go through a two-stage cp.async
// ring with one barrier a tile, so the next tile's copies are in flight
// while the current one computes: 16-byte copies where every base and the
// row length are 16-byte aligned, else 4-byte copies (f32, even-hd bf16),
// else plain 2-byte loads (odd-hd bf16), chosen per call; rows at or past S
// are copies of source size 0, which zero-fill.  The output is staged in
// the warp's own q rows and stored in 16-byte pieces where the copies in
// were.  The causal upper bound and the window lower bound skip whole
// tiles; a warp skips a tile in which all its pairs are masked, and only
// tiles that cross the diagonal, the window edge or S apply the mask.  In
// causal mode the grid runs the longest q tiles first.  Keys a stage and
// shared memory: bf16 64 / 48 / 32 keys, 55 / 87 / 101 KB at hd 64 / 128 /
// 256; f32 32 / 32 (16 with two m-tiles) / 32 keys, 73 / 103 / 202 KB; rows
// padded so fragment loads are free of bank conflicts, and a stage sized so
// that o, the score tile and the fragments fit in 255 registers without a
// spill (64 bf16 keys spill at hd 128).  Past the 48 KB default, hence
// cudaFuncSetAttribute, once per instance, at its first launch (outside
// any CUDA graph capture).
// mma.sync and not wgmma: a version with both products on wgmma (q, k, v in
// core-matrix layout, p from registers) was right on the card but no
// faster: the time is in the softmax, the tile barrier and the output, not
// in issuing products (PERF.md).
//
// Build: see repro_torch/kernels/build.py.  Plain C interface; each entry
// point launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;  // the k/v ring
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// Tile shape of one instance (T the input type, HD its head dim, hd <= HD
// zero-filled up to HD, MT 16-row m-tiles a warp): BQ query rows a block,
// BK keys a stage, and the padded row strides (elements) of the q, k and v
// tiles.
template <typename T, int HD, int MT>
struct Tile;
template <int HD, int MT>
struct Tile<bf16, HD, MT> {
  // 64 keys a stage spill registers past hd 64 (o and s in registers)
  static constexpr int BK = HD > 128 ? 32 : HD > 64 ? 48 : 64;
  // ldmatrix rows: a stride of an odd number of 16-byte units
  static constexpr int LDQ = HD + 8, LDK = HD + 8, LDV = HD + 8;
  static constexpr int BQ = 16 * WARPS * MT;
};
template <int HD, int MT>
struct Tile<float, HD, MT> {
  static constexpr int BK = (HD > 64 ? 32 : 64) / MT;
  // 8-byte q/k fragment loads want LDQ = LDK = 8 (mod 16); the 4-byte v
  // loads two keys apart want LDV = 4 (mod 8)
  static constexpr int LDQ = HD + 8, LDK = HD + 8, LDV = HD + 4;
  static constexpr int BQ = 16 * WARPS * MT;
};

template <typename T, int HD, int MT>
constexpr size_t smem_bytes() {
  using C = Tile<T, HD, MT>;
  return (size_t)(C::BQ * C::LDQ + STAGES * C::BK * (C::LDK + C::LDV)) *
         sizeof(T);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void copy_one(T* dst, const T* src, bool ok,
                                         int bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0));
  } else {
    *dst = ok ? *src : T(0.f);
  }
}

// Copies rows [0, ROWS) x columns [0, hd) of the row-major [*, hd] block
// at g into the shared tile s (row stride LD), `per` elements a copy.
// Rows at or past `valid` are zero-filled.  The rows of g are contiguous,
// so copy i starts at element i * per of g.  Full rows of 16-byte copies
// (hd == HD) have a compile-time row length; any other shape divides.
template <typename T, int ROWS, int LD, int HD>
__device__ __forceinline__ void load_rows(T* s, const T* g, int valid,
                                          int hd, int per, int tid) {
  constexpr int PER = 16 / (int)sizeof(T), CH = HD / PER;
  if (per == PER && hd == HD) {
#pragma unroll
    for (int i = tid; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = r < valid;
      copy_one(s + r * LD + c * PER, ok ? g + i * PER : g, ok, 16);
    }
  } else {
    const int ch = hd / per, bytes = per * (int)sizeof(T);
    for (int i = tid; i < ROWS * ch; i += THREADS) {
      const int r = i / ch, c = i - r * ch;
      const bool ok = r < valid;
      copy_one(s + r * LD + c * per, ok ? g + (long long)i * per : g, ok,
               bytes);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi rounded to TF32, lo the exact f32 residual (the tensor
// core reads its top 19 bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0: such a
// weight adds nothing to a sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One warp's scores s = q k^T over a key tile: its MT x 16 query rows (qw,
// row stride LDQ) against BK keys (ks, row stride LDK), depth HD.  Lane
// (g = lane / 4, t = lane % 4) holds s[mt][n] = rows 16 mt + g and
// 16 mt + g + 8, keys 8n + 2t and 8n + 2t + 1 (the mma accumulator
// layout).
template <int MT, int BK, int HD, int LDQ, int LDK>
__device__ __forceinline__ void scores(float (&s)[MT][BK / 8][4],
                                       const bf16* qw, const bf16* ks,
                                       int lane) {
#pragma unroll
  for (int d0 = 0; d0 < HD; d0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt],
              qw + (16 * mt + (lane & 15)) * LDQ + d0 + 8 * (lane >> 4));
#pragma unroll
    for (int n = 0; n < BK / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, ks + (8 * n + (lane & 7) + 8 * (lane >> 4)) * LDK + d0 +
                     8 * ((lane >> 3) & 1));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][n], a[mt], b[0], b[1]);
        mma_bf16(s[mt][n + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int MT, int BK, int HD, int LDQ, int LDK>
__device__ __forceinline__ void scores(float (&s)[MT][BK / 8][4],
                                       const float* qw, const float* ks,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  // 3xTF32's small terms (al bh + ah bl) go to their own accumulator, so
  // each product is two independent chains; al bl is below f32's last
  // bit and left out
  float lo[MT][BK / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      lo[mt][n][0] = lo[mt][n][1] = lo[mt][n][2] = lo[mt][n][3] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < HD; d0 += 8) {
    // logical depth t and t + 4 are physical 2t and 2t + 1
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* qr = qw + (16 * mt + g) * LDQ + d0 + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(qr);
      const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * LDQ);
      split(x0.x, ah[mt][0], al[mt][0]);
      split(x1.x, ah[mt][1], al[mt][1]);
      split(x0.y, ah[mt][2], al[mt][2]);
      split(x1.y, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(
          ks + (8 * n + g) * LDK + d0 + 2 * t);
      uint32_t bh0, bl0, bh1, bl1;
      split(y.x, bh0, bl0);
      split(y.y, bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32(lo[mt][n], al[mt], bh0, bh1);
        mma_tf32(lo[mt][n], ah[mt], bl0, bl1);
        mma_tf32(s[mt][n], ah[mt], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[mt][n][i] += lo[mt][n][i];
}

// The accumulator layout of two 8-key score tiles is the A layout of one
// 16-key step: p[mt][j] is the bf16 A operand of keys 16j .. 16j + 15.
__device__ __forceinline__ void pack_p(uint32_t (&a)[4], const float (&p0)[4],
                                       const float (&p1)[4]) {
  a[0] = pack_bf16(p0[0], p0[1]);
  a[1] = pack_bf16(p0[2], p0[3]);
  a[2] = pack_bf16(p1[0], p1[1]);
  a[3] = pack_bf16(p1[2], p1[3]);
}

// o += p v over a key tile (vs, row stride LDV), p the tile's weights
// after the softmax (bf16 A operands, or f32 in the score layout).
// Output column pair 8n + 2t, +1 of rows g, g + 8 of m-tile mt in o[mt][n].
template <int MT, int BK, int HD, int LDV>
__device__ __forceinline__ void accumulate(float (&o)[MT][HD / 8][4],
                                           uint32_t (&p)[MT][BK / 16][4],
                                           const bf16* vs, int lane) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + (16 * j + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDV +
                       8 * n + 8 * (lane >> 4));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][n], p[mt][j], b[0], b[1]);
        mma_bf16(o[mt][n + 1], p[mt][j], b[2], b[3]);
      }
    }
  }
}

template <int MT, int BK, int HD, int LDV>
__device__ __forceinline__ void accumulate(float (&o)[MT][HD / 8][4],
                                           float (&p)[MT][BK / 8][4],
                                           const float* vs, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    // logical key t and t + 4 are keys 2t and 2t + 1 of the 8-key step,
    // exactly the two columns lane t holds in the score accumulator
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split(p[mt][j][0], ah[mt][0], al[mt][0]);
      split(p[mt][j][2], ah[mt][1], al[mt][1]);
      split(p[mt][j][1], ah[mt][2], al[mt][2]);
      split(p[mt][j][3], ah[mt][3], al[mt][3]);
    }
    const float* vr = vs + (8 * j + 2 * t) * LDV + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split(vr[8 * n], bh0, bl0);
      split(vr[LDV + 8 * n], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32(o[mt][n], al[mt], bh0, bh1);
        mma_tf32(o[mt][n], ah[mt], bl0, bl1);
        mma_tf32(o[mt][n], ah[mt], bh0, bh1);
      }
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int HD, int MT>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int BH, int H, int KV, int S, int hd, int causal, int window,
    float scale, int per) {
  using C = Tile<T, HD, MT>;
  constexpr int BQ = C::BQ, BK = C::BK;
  constexpr int LDQ = C::LDQ, LDK = C::LDK, LDV = C::LDV;
  constexpr int NT = BK / 8, ON = HD / 8, WR = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LDQ]
  T* ks = qs + BQ * LDQ;                   // [STAGES][BK][LDK]
  T* vs = ks + STAGES * BK * LDK;          // [STAGES][BK][LDV]

  const int nq = (S + BQ - 1) / BQ;
  const int tile = blockIdx.x / BH, bh = blockIdx.x - tile * BH;
  const int qt = causal ? nq - 1 - tile : tile;  // longest tiles first
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * BQ;
  const long long kvoff = (long long)(b * KV + h / (H / KV)) * S * hd;
  const T* kg = k + kvoff;
  const T* vg = v + kvoff;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // columns hd .. HD of every tile are read by the products and never
  // written by a copy: zero them once
  if (hd < HD) {
    const int w = HD - hd;
    for (int i = tid; i < (BQ + STAGES * BK) * w; i += THREADS) {
      const int r = i / w, c = hd + i - r * w;
      if (r < BQ)
        qs[r * LDQ + c] = T(0.f);
      else
        ks[(r - BQ) * LDK + c] = T(0.f);
      if (r < STAGES * BK) vs[r * LDV + c] = T(0.f);
    }
  }

  const int nk = (S + BK - 1) / BK;
  // causal upper bound: key tiles past the diagonal contribute nothing
  const int hi = causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;
  // window lower bound: the first tile that can reach the earliest query
  const int lo = window >= 0 && q0 - window > 0 ? (q0 - window) / BK : 0;

  // the ring: tile lo + i goes to stage i % STAGES; the q tile rides with
  // the first group
  load_rows<T, BQ, LDQ, HD>(qs, q + ((long long)bh * S + q0) * hd, S - q0,
                            hd, per, tid);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (lo + i < hi) {
      const long long off = (long long)(lo + i) * BK * hd;
      const int valid = S - (lo + i) * BK;
      load_rows<T, BK, LDK, HD>(ks + i * BK * LDK, kg + off, valid, hd, per,
                                tid);
      load_rows<T, BK, LDV, HD>(vs + i * BK * LDV, vg + off, valid, hd, per,
                                tid);
    }
    cp_async_commit();
  }

  const int qw = q0 + WR * warp;  // this warp's first query row
  const T* qsw = qs + WR * warp * LDQ;
  const float sl2 = scale * LOG2E;  // scale and log2(e) in one multiply
  float o[MT][ON][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < ON; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = lo; j < hi; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed
    // every warp is past tile j - 1: its stage takes the copies of tile
    // j + STAGES - 1, which fly while tile j computes
    __syncthreads();
    {
      const int jn = j + STAGES - 1;
      if (jn < hi) {
        const int sn = (jn - lo) % STAGES;
        const long long off = (long long)jn * BK * hd;
        const int valid = S - jn * BK;
        load_rows<T, BK, LDK, HD>(ks + sn * BK * LDK, kg + off, valid, hd,
                                  per, tid);
        load_rows<T, BK, LDV, HD>(vs + sn * BK * LDV, vg + off, valid, hd,
                                  per, tid);
      }
      cp_async_commit();
    }
    const int st = (j - lo) % STAGES;
    const int k0 = j * BK;
    // skip: every (row, key) pair of this warp is masked
    const bool skip = (causal && k0 > qw + WR - 1) ||
                      (window >= 0 && k0 + BK - 1 <= qw - window);
    if (!skip) {
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
      scores<MT, BK, HD, LDQ, LDK>(s, qsw, ks + st * BK * LDK, lane);
      // edge: some pair of this warp is masked (diagonal, window, S)
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qw) ||
                        (window >= 0 && k0 <= qw + WR - 1 - window);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[mt][n][i] * sl2;
            if (edge) {
              const int qi = qw + 16 * mt + g + 8 * (i >> 1);
              const int ki = k0 + 8 * n + 2 * t + (i & 1);
              bool ok = ki < S;
              if (causal) ok = ok && ki <= qi;
              if (window >= 0) ok = ok && ki > qi - window;
              x = ok ? x : NEG_INF;
            }
            s[mt][n][i] = x;
          }
          mx0 = fmaxf(mx0, fmaxf(s[mt][n][0], s[mt][n][1]));
          mx1 = fmaxf(mx1, fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
        const float c0 = ex2(m[mt][0] - mx0), c1 = ex2(m[mt][1] - mx1);
        m[mt][0] = mx0;
        m[mt][1] = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          s[mt][n][0] = ex2(s[mt][n][0] - mx0);
          s[mt][n][1] = ex2(s[mt][n][1] - mx0);
          s[mt][n][2] = ex2(s[mt][n][2] - mx1);
          s[mt][n][3] = ex2(s[mt][n][3] - mx1);
          sum0 += s[mt][n][0] + s[mt][n][1];
          sum1 += s[mt][n][2] + s[mt][n][3];
        }
        // this lane's columns; the row sum is taken at the end
        l[mt][0] = l[mt][0] * c0 + sum0;
        l[mt][1] = l[mt][1] * c1 + sum1;
        // once the row maxima settle, most tiles leave them: rescale only
        // when some row of the warp moved
        if (__any_sync(FULL, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
          for (int n = 0; n < ON; ++n) {
            o[mt][n][0] *= c0;
            o[mt][n][1] *= c0;
            o[mt][n][2] *= c1;
            o[mt][n][3] *= c1;
          }
        }
      }
      if constexpr (std::is_same<T, bf16>::value) {
        uint32_t p[MT][NT / 2][4];  // s dies here: only its bf16 copy lives
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NT / 2; ++j)
            pack_p(p[mt][j], s[mt][2 * j], s[mt][2 * j + 1]);
        accumulate<MT, BK, HD, LDV>(o, p, vs + st * BK * LDV, lane);
      } else {
        accumulate<MT, BK, HD, LDV>(o, s, vs + st * BK * LDV, lane);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can be left

  // the warp's own q rows are read no more: stage its output there, then
  // store whole rows
  T* ow = qs + WR * warp * LDQ;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    // lse = m + log(l) in natural-log units of scale q k (m is held in
    // base 2); one lane of the four that share a row stores it
    if (lse != nullptr && t == 0) {
      const int r = qw + 16 * mt + g;
      float* lr = lse + (long long)bh * S;
      if (r < S) lr[r] = m[mt][0] * LN2 + logf(fmaxf(l0, 1e-30f));
      if (r + 8 < S) lr[r + 8] = m[mt][1] * LN2 + logf(fmaxf(l1, 1e-30f));
    }
    T* om = ow + 16 * mt * LDQ;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      store_pair(om + g * LDQ + 8 * n + 2 * t, o[mt][n][0] * inv0,
                 o[mt][n][1] * inv0);
      store_pair(om + (g + 8) * LDQ + 8 * n + 2 * t, o[mt][n][2] * inv1,
                 o[mt][n][3] * inv1);
    }
  }
  __syncwarp();
  // the warp's rows are contiguous in out: 16-byte stores where the copies
  // in were 16 bytes wide (the same alignment holds for out)
  T* og = out + ((long long)bh * S + qw) * hd;
  const int rows = min(WR, S - qw);
  constexpr int PER = 16 / (int)sizeof(T), CH = HD / PER;
  if (per == PER && hd == HD) {
    for (int i = lane; i < rows * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      *reinterpret_cast<uint4*>(og + r * HD + c * PER) =
          *reinterpret_cast<const uint4*>(ow + r * LDQ + c * PER);
    }
  } else {
    for (int r = 0; r < rows; ++r)
      for (int c = lane; c < hd; c += 32) og[r * hd + c] = ow[r * LDQ + c];
  }
}

template <typename T, int HD, int MT>
int prepare() {
  // raise the instance's shared-memory limit once, so later launches (a
  // CUDA graph capture included) make no attribute call
  static bool limit_set = false;
  if (!limit_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, HD, MT>());
    if (err != cudaSuccess) return (int)err;
    limit_set = true;
  }
  return 0;
}

// Blocks of the instance that one wave of the card holds (0 on an error),
// found once.
template <typename T, int HD, int MT>
int wave() {
  static int n = -1;
  if (n < 0) {
    int dev = 0, sms = 0, per = 0;
    if (prepare<T, HD, MT>() || cudaGetDevice(&dev) ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, flash_kernel<T, HD, MT>, THREADS,
            smem_bytes<T, HD, MT>()))
      return 0;
    n = sms * per;
  }
  return n;
}

template <int HD_, int MT_>
struct Inst {
  static constexpr int HD = HD_, MT = MT_;
};

// f32 at hd 65 .. 128 has two instances.  Two m-tiles a warp use each k/v
// fragment (and its TF32 split) twice, but give half the blocks; a causal
// grid of fewer than two waves of them is then left unbalanced (the
// diagonal's blocks take all the keys), so it takes one m-tile a warp.
template <typename T, int HD, typename F>
int pick(int B, int H, int S, int causal, F&& f) {
  constexpr int BQ2 = Tile<T, HD, 2>::BQ;
  const long long blocks = (long long)((S + BQ2 - 1) / BQ2) * B * H;
  if (!causal || blocks >= 2LL * wave<T, HD, 2>()) return f(Inst<HD, 2>());
  return f(Inst<HD, 1>());
}

// Calls f(Inst<HD, MT>()) with the instance that takes a call: head dims
// are zero-filled up to the next instance's HD.
template <typename T, typename F>
int with_instance(int B, int H, int S, int hd, int causal, F&& f) {
  constexpr bool is_f32 = std::is_same<T, float>::value;
  if (hd < 1) return (int)cudaErrorInvalidValue;
  if (hd <= 32) return f(Inst<32, 2>());
  if (hd <= 64) return f(Inst<64, 2>());
  if (hd <= 96) {
    if constexpr (is_f32) return pick<T, 96>(B, H, S, causal, f);
    return f(Inst<96, 2>());
  }
  if (hd <= 128) {
    if constexpr (is_f32) return pick<T, 128>(B, H, S, causal, f);
    return f(Inst<128, 2>());
  }
  if (hd <= 192) return f(Inst<192, 1>());
  if (hd <= 256) return f(Inst<256, 1>());
  return (int)cudaErrorInvalidValue;
}

// Elements a copy (in and out): 16 bytes where every base and the row
// length are 16-byte aligned, else 4 bytes, else (bf16 rows of odd length
// or bases 2 bytes off) one element by a plain load; 0 when nothing fits.
template <typename T>
int copy_width(const void* q, const void* k, const void* v, const void* out,
               int hd) {
  const uintptr_t bases =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  const size_t row = (size_t)hd * sizeof(T);
  if (bases % 16 == 0 && row % 16 == 0) return 16 / (int)sizeof(T);
  if (bases % 4 == 0 && row % 4 == 0) return 4 / (int)sizeof(T);
  return sizeof(T) == 2 && bases % 2 == 0 ? 1 : 0;
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, float* lse, int B,
             int H, int KV, int S, int hd, int causal, int window,
             float scale, void* stream) {
  const int per = copy_width<T>(q, k, v, out, hd);
  if (per == 0) return (int)cudaErrorInvalidValue;
  return with_instance<T>(B, H, S, hd, causal, [&](auto inst) {
    using I = decltype(inst);
    const int err = prepare<T, I::HD, I::MT>();
    if (err) return err;
    constexpr int BQ = Tile<T, I::HD, I::MT>::BQ;
    const long long blocks = (long long)((S + BQ - 1) / BQ) * B * H;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    flash_kernel<T, I::HD, I::MT>
        <<<(unsigned)blocks, THREADS, smem_bytes<T, I::HD, I::MT>(),
           (cudaStream_t)stream>>>(q, k, v, out, lse, B * H, H, KV, S, hd,
                                   causal, window, scale, per);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int occupancy(int B, int H, int S, int hd, int causal, int* info) {
  return with_instance<T>(B, H, S, hd, causal, [&](auto inst) {
    using I = decltype(inst);
    using C = Tile<T, I::HD, I::MT>;
    const int err = prepare<T, I::HD, I::MT>();
    if (err) return err;
    info[0] = C::BQ;
    info[1] = C::BK;
    info[2] = (int)smem_bytes<T, I::HD, I::MT>();
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[3], flash_kernel<T, I::HD, I::MT>, THREADS,
        smem_bytes<T, I::HD, I::MT>());
  });
}

}  // namespace

// lse: null, or f32 [B, H, S] that takes each query row's log-sum-exp of
// its masked scale q k scores (what the flash backward recomputes p from).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, float* lse,
                                   int B, int H, int KV, int S, int hd,
                                   int causal, int window, float scale,
                                   void* stream) {
  return dispatch(q, k, v, out, lse, B, H, KV, S, hd, causal, window, scale,
                  stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int B, int H, int KV, int S, int hd,
                                    int causal, int window, float scale,
                                    void* stream) {
  return dispatch((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
                  lse, B, H, KV, S, hd, causal, window, scale, stream);
}

// The launch shape of the instance that takes a call: info = {query rows a
// block, keys a stage, dynamic shared bytes, blocks an SM holds}.
extern "C" int flash_attention_occupancy(int is_bf16, int B, int H, int S,
                                         int hd, int causal, int* info) {
  return is_bf16 ? occupancy<bf16>(B, H, S, hd, causal, info)
                 : occupancy<float>(B, H, S, hd, causal, info);
}
