// Shared implicit-GEMM tile loop for Hopper (sm_90a), included by
// conv2d_shard.cu and matmul_tiled.cu.  (The file keeps its first name:
// the loop started as f32 only.)
//
// out[M, N] = A[M, Kdim] @ B[Kdim, N], where A is the implicit im2col matrix
// of a conv shard and B the weight flattened over (kh, kw, ci):
//
//   m  -> output pixel (ho, wo) = (m / Wo, m % Wo)
//   kk -> tap (kh, kw) and input channel ci, kk = (kh * K + kw) * Cin + ci
//   A[m, kk] = x[ho*S - pt + kh, wo*S - pl + kw, ci], 0 outside [0, Hl) x
//              [0, Wl) (the shard's graph-boundary zero pads)
//   B[kk, n] = w[kh, kw, ci, n]
//
// An FC shard x[M, Cin] @ w[Cin, N] is the 1x1 case over an [M, 1, Cin] map.
// Activations are read in place through their row and column strides
// (channel stride 1), the weight through all four strides, so halo views
// and OutC channel views are never copied.
//
// Element types: the loop is a template on the types of x (TX), w (TW) and
// out (TO), each float, __nv_bfloat16 or __half.  Slabs sit in shared
// memory in their own types.  Two compute loops read them:
//
// * the tensor-core loop (mma_kernel), for x and w in one 2-byte type:
//   each warp reads its fragments with ldmatrix, untouched, and multiplies
//   them with mma.sync.m16n8k16 (bf16 or fp16 operands, f32 accumulators
//   in registers).  The products are exact in f32; how the tensor core
//   adds a step's 16 products to the accumulator is the hardware's.
// * the CUDA-core loop (gemm_kernel), for f32 and the mixed pairs (a
//   2-byte x with f32 weights): every element is converted to f32 when a
//   thread reads it into registers and the products are f32 FMAs (no
//   TF32: the f32 route keeps the reference's 1e-4).
//
// Either way the K groups' sum and the split-K sum are f32, and the
// output is rounded once to TO (round to nearest even) where it is
// written: by the tile's epilogue with one split, after the f32 sum of
// the splits otherwise (splitk_reduce).
//
// The loop: a block owns a BM x 64 output tile and one K chunk of
// `kchunk` (a multiple of BK).  BK-deep slabs of A and B stream through a
// 3-stage ring in shared memory: while the block computes on slab t,
// slabs t+1 and t+2 are in flight.  A pad tap or a ragged edge is a
// cp.async with source size 0, which fills the shared-memory tile with
// zeros without touching device memory.  KG groups of 128 threads split
// each slab's depth and add their tiles in shared memory at the end, in
// group order.  On CUDA cores each thread keeps a TM x 4 register tile,
// so four B values read from shared memory feed 4*TM FMAs; on the tensor
// cores each of a group's four warps keeps MI x NI m16n8 accumulator
// fragments.  A 1x1 conv or FC shard (K == 1) takes a one-tap path: each
// row's x offset is set once per block and k is the channel, so the
// loaders do no tap arithmetic.
//
// Split-K: with splits > 1 the blocks of chunk s write their partial tile
// to ws[s, M, N] (an f32 workspace the caller allocates) and a second
// pass sums the splits in the fixed order 0, 1, ..., splits-1.  No
// atomics: the same call gives the same bits every time.  Every pass is
// launched as a
// programmatic dependent (Hopper), so each one's launch overlaps the
// tail of the kernel before it.
//
// Routes, chosen by the caller from alignment, per operand: AVEC loads A
// as 16-byte cp.async.cg (16 / sizeof(TX) channels: 4 in f32, 8 in a
// 2-byte type; needs Cin a multiple of that, a 16-byte aligned x and row
// and column strides that are multiples of it), else one element a copy
// (a 4-byte cp.async.ca in f32, a plain load in a 2-byte type, which
// cp.async cannot copy); BVEC loads B as 16-byte copies along n (needs
// unit output-channel stride, a 16-byte aligned w and the other strides
// multiples of 16 / sizeof(TW)), else one element a copy.  The launcher
// re-checks each precondition and returns cudaErrorInvalidValue rather
// than launch a misaligned copy, a tile config that is not the pair's
// loop (a tensor-core config for f32 or a mixed pair, a CUDA-core one for
// a same-type 2-byte pair) or a split without a workspace.

#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace gemm_f32 {

template <typename TX, typename TW, typename TO>
struct Problem {
  const TX* x;
  const TW* w;
  TO* out;
  float* ws;  // [splits, M, N] when splits > 1
  int M, N, Kdim;
  int Hl, Wl, Cin, K, S, pt, pl, Wo;
  long long sxh, sxw;            // x strides (channel stride 1)
  long long swh, sww, swi, swo;  // w strides
  long long ldo;                 // out row stride
  int kchunk, splits;
};

// A block is KG groups of 128 threads.  In a group, 16 thread columns x
// (BM / TM) thread rows each hold a TM x 4 register tile, so the block
// tile is BM x 64.  The KG groups split every slab's depth between them
// (group g takes its g-th BK/KG slice) and sum their tiles in shared
// memory, in group order, at the end: KG times the warps on one tile,
// without workspace traffic.  The configurations are listed in launch().
constexpr int kGroup = 128;
constexpr int kTX = 16;
constexpr int kBN = kTX * 4;

// elements of type T in one 16-byte copy
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// ---- element conversions: f32 on read, one rounding on write ----

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ unsigned bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned bits16(__half v) {
  return __half_as_ushort(v);
}

// Four consecutive elements in shared memory (8- or 16-byte aligned) as
// f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the high half of its f32: the conversion is a shift
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(
      __half2float(__ushort_as_half((unsigned short)(u.x & 0xffffu))),
      __half2float(__ushort_as_half((unsigned short)(u.x >> 16))),
      __half2float(__ushort_as_half((unsigned short)(u.y & 0xffffu))),
      __half2float(__ushort_as_half((unsigned short)(u.y >> 16))));
}

// Four consecutive outputs, each rounded once to T (16- or 8-byte
// aligned).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bits16(from_f32<T>(v.x)) | bits16(from_f32<T>(v.y)) << 16,
                 bits16(from_f32<T>(v.z)) | bits16(from_f32<T>(v.w)) << 16);
}

// ---- copies from device to shared memory ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// One element, or a zero where !ok: a 4-byte cp.async for f32; a plain
// load and store for a 2-byte type (cp.async copies 4, 8 or 16 bytes).
// A plain store is visible to the block after the next __syncthreads,
// as the ring's cp.async copies are after their wait.
template <typename T>
__device__ __forceinline__ void copy1(T* smem, const T* gmem, bool ok) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(smem, gmem, ok ? 4 : 0);
  } else {
    static_assert(sizeof(T) == 2, "f32 or a 2-byte type");
    *reinterpret_cast<unsigned short*>(smem) =
        ok ? *reinterpret_cast<const unsigned short*>(gmem)
           : (unsigned short)0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tap (kh, kw) and channel ci of the flattened index k0 + d, from the
// slab start's decomposition (tap0 = k0 / Cin, ci0, kh0, kw0).  A slab
// inside one tap (every dense layer with Cin a multiple of BK) never takes
// the division.
struct Tap {
  int kh, kw, ci;
};

template <typename P>
__device__ __forceinline__ Tap tap_of(const P& p, int tap0, int kh0, int kw0,
                                      int ci0, int d) {
  int ci = ci0 + d;
  if (ci < p.Cin) return {kh0, kw0, ci};
  const int q = ci / p.Cin;
  const int tap = tap0 + q;
  ci -= q * p.Cin;
  const int kh = tap / p.K;
  return {kh, tap - kh * p.K, ci};
}

// Row stride of the A slab in shared memory, in elements: BK plus one
// 16-byte copy, so every row starts 16-byte aligned.  In a 2-byte type
// that is 80 bytes (BK 32) or 144 (BK 64): an ldmatrix over 8 rows of
// one column block then touches 8 distinct bank quads.
template <int BK, typename TX>
constexpr int kAStride = BK + kVec<TX>;

// Row stride of the B slab in shared memory, in elements: the CUDA-core
// loop reads rows of kBN unpadded (a thread reads 4 consecutive columns);
// the tensor-core loop pads each row by one 16-byte copy (72 elements,
// 144 bytes), so the 8 k-rows of one ldmatrix.trans fall on 8 distinct
// bank quads instead of one, and every row stays 16-byte aligned.
template <bool MMA, typename TW>
constexpr int kBStride = MMA ? kBN + kVec<TW> : kBN;

// Issues the copies of one slab, flattened K index k0 .. k0+BK-1 (only
// those below ke are live), into the stage buffers as (rows kAStride
// apart) and bs (rows BST apart).  The slab's first tap is decomposed
// once; a row inside it costs one add.
template <int BM, int BN, int BST, int BK, int THREADS, bool K1, bool AVEC,
          bool BVEC, typename TX, typename TW, typename TO>
__device__ __forceinline__ void load_slab(const Problem<TX, TW, TO>& p,
                                          const int* rowh, const int* roww,
                                          const long long* rowoff, TX* as,
                                          TW* bs, int k0, int ke, int n0,
                                          int tid) {
  constexpr int AST = kAStride<BK, TX>;
  // a 1x1 conv (or FC) has one tap: k is the channel, no decomposition
  const int tap0 = K1 ? 0 : k0 / p.Cin;
  const int ci0 = K1 ? k0 : k0 - tap0 * p.Cin;
  const int kh0 = K1 ? 0 : tap0 / p.K;
  const int kw0 = K1 ? 0 : tap0 - kh0 * p.K;
  // A: BM rows x BK flattened (kh, kw, ci); consecutive threads take
  // consecutive channels of one row
  constexpr int AW = AVEC ? kVec<TX> : 1;  // elements per copy
  constexpr int ACPR = BK / AW;            // copies per row
  for (int c = tid; c < BM * ACPR; c += THREADS) {
    const int r = c / ACPR, d = (c % ACPR) * AW;
    bool ok;
    const TX* src;
    if constexpr (K1) {
      ok = rowoff[r] >= 0 && k0 + d < ke;
      src = ok ? p.x + rowoff[r] + k0 + d : p.x;
    } else {
      const Tap tp = tap_of(p, tap0, kh0, kw0, ci0, d);
      const int h = rowh[r] + tp.kh, wi = roww[r] + tp.kw;
      ok = k0 + d < ke && (unsigned)h < (unsigned)p.Hl &&
           (unsigned)wi < (unsigned)p.Wl;
      src = ok ? p.x + h * p.sxh + wi * p.sxw + tp.ci : p.x;
    }
    if constexpr (AVEC)
      cp_async16(as + r * AST + d, src, ok ? 16 : 0);
    else
      copy1(as + r * AST + d, src, ok);
  }
  // B: BK rows x BN output channels; consecutive threads take consecutive
  // channels of one row
  const TW* w0 = p.w + kh0 * p.swh + kw0 * p.sww + ci0 * p.swi;
  constexpr int BW = BVEC ? kVec<TW> : 1;
  constexpr int BCPR = BN / BW;
  for (int c = tid; c < BK * BCPR; c += THREADS) {
    const int d = c / BCPR, n = (c % BCPR) * BW;
    const int gn = n0 + n;
    const TW* row;
    if (K1 || ci0 + d < p.Cin) {
      row = w0 + d * p.swi;
    } else {
      const Tap tp = tap_of(p, tap0, kh0, kw0, ci0, d);
      row = p.w + tp.kh * p.swh + tp.kw * p.sww + tp.ci * p.swi;
    }
    if constexpr (BVEC) {
      const int live = k0 + d < ke ? min(BW, max(0, p.N - gn)) : 0;
      cp_async16(bs + d * BST + n, live ? row + gn : p.w,
                 live * (int)sizeof(TW));
    } else {
      const bool ok = k0 + d < ke && gn < p.N;
      copy1(bs + d * BST + n, ok ? row + gn * p.swo : p.w, ok);
    }
  }
}

// Programmatic dependent launch (Hopper): a kernel launched with the
// programmatic-serialization attribute may start while the kernel before
// it in the stream finishes; griddepcontrol.wait blocks until that kernel
// has completed and its writes are visible, and launch_dependents lets
// the next one start early.  Both are no-ops without such a launch.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The top-left input tap of each of the tile's BM output rows; rows past
// M get a row index that fails every bound check (K1: offset -1 for a
// row past M or a tap in the pads).
template <int BM, int THREADS, typename P>
__device__ __forceinline__ void set_rows(const P& p, int m0, int* rowh,
                                         int* roww, long long* rowoff,
                                         int tid) {
  for (int r = tid; r < BM; r += THREADS) {
    const int m = m0 + r;
    if (m < p.M) {
      const int ho = m / p.Wo;
      rowh[r] = ho * p.S - p.pt;
      roww[r] = (m - ho * p.Wo) * p.S - p.pl;
    } else {
      rowh[r] = INT_MIN / 2;
      roww[r] = 0;
    }
    const bool in = (unsigned)rowh[r] < (unsigned)p.Hl &&
                    (unsigned)roww[r] < (unsigned)p.Wl;
    rowoff[r] = in ? rowh[r] * p.sxh + roww[r] * p.sxw : -1;
  }
}

// The CUDA-core loop: f32 and the mixed pairs.
template <int BM, int BK, int TM, int KG, int STAGES, bool K1, bool AVEC,
          bool BVEC, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kGroup* KG)
    gemm_kernel(const __grid_constant__ Problem<TX, TW, TO> p) {
  constexpr int THREADS = kGroup * KG;
  constexpr int BN = kBN;
  constexpr int KS = BK / KG;  // slab depth of one group
  static_assert(kTX * (BM / TM) == kGroup, "tile does not match threads");
  static_assert(KS % 4 == 0, "a group takes whole 4-element steps");
  constexpr int AST = kAStride<BK, TX>;  // A row stride in elements
  constexpr int A_BYTES = BM * AST * (int)sizeof(TX);
  constexpr int B_BYTES = BK * BN * (int)sizeof(TW);
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0,
                "every stage buffer starts 16-byte aligned");
  // the stage ring, or at the end the KG-1 parked f32 tiles of the group
  // sum
  constexpr int RING = STAGES * (A_BYTES + B_BYTES);
  constexpr int PARK = (KG - 1) * BM * BN * (int)sizeof(float);
  __shared__ __align__(16) unsigned char smem[RING > PARK ? RING : PARK];
  __shared__ int rowh[BM], roww[BM];
  __shared__ long long rowoff[BM];  // K1: x offset of the row's one tap
  TX* const As = reinterpret_cast<TX*>(smem);  // [STAGES][BM * AST]
  TW* const Bs =
      reinterpret_cast<TW*>(smem + STAGES * A_BYTES);  // [STAGES][BK * BN]

  const int tid = threadIdx.x;
  const int kg = tid / kGroup;
  const int tx = tid % kTX, ty = tid % kGroup / kTX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.kchunk;
  const int ke = min(p.Kdim, kb + p.kchunk);
  const int nslab = (ke - kb + BK - 1) / BK;

  set_rows<BM, THREADS>(p, m0, rowh, roww, rowoff, tid);
  __syncthreads();
  wait_prior_grid();
  release_dependents();

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab)
      load_slab<BM, BN, BN, BK, THREADS, K1, AVEC, BVEC>(
          p, rowh, roww, rowoff, As + s * BM * AST, Bs + s * BK * BN,
          kb + s * BK, ke, n0, tid);
    cp_async_commit();
  }
  for (int t = 0; t < nslab; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab t landed for all; stage (t-1) % STAGES is free
    const int nxt = t + STAGES - 1;
    if (nxt < nslab)
      load_slab<BM, BN, BN, BK, THREADS, K1, AVEC, BVEC>(
          p, rowh, roww, rowoff, As + (nxt % STAGES) * BM * AST,
          Bs + (nxt % STAGES) * BK * BN, kb + nxt * BK, ke, n0, tid);
    cp_async_commit();

    const TX* as = As + (t % STAGES) * BM * AST + ty * TM * AST + kg * KS;
    const TW* bs = Bs + (t % STAGES) * BK * BN + kg * KS * BN + tx * 4;
#pragma unroll
    for (int k = 0; k < KS; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = load4(as + i * AST + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = load4(bs + (k + q) * BN);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a[i].x
                           : q == 1 ? a[i].y
                           : q == 2 ? a[i].z
                                    : a[i].w;
          acc[i][0] = fmaf(av, b.x, acc[i][0]);
          acc[i][1] = fmaf(av, b.y, acc[i][1]);
          acc[i][2] = fmaf(av, b.z, acc[i][2]);
          acc[i][3] = fmaf(av, b.w, acc[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (KG > 1) {
    // groups 1 .. KG-1 park their tiles in the (now idle) ring; group 0
    // adds them in group order
    float* const parked = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (kg > 0) {
      float* park = parked + (kg - 1) * BM * BN + ty * TM * BN + tx * 4;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(park + i * BN) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int g = 0; g < KG - 1; ++g) {
      const float* park = parked + g * BM * BN + ty * TM * BN + tx * 4;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(park + i * BN);
        acc[i][0] += v.x;
        acc[i][1] += v.y;
        acc[i][2] += v.z;
        acc[i][3] += v.w;
      }
    }
  }

  // one split: the output, rounded once to TO; several: this chunk's f32
  // partial tile
  const bool partial = p.splits > 1;
  float* const part = p.ws + (long long)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.N) continue;
      if (partial)
        part[(long long)m * p.N + n] = acc[i][j];
      else
        p.out[m * p.ldo + n] = from_f32<TO>(acc[i][j]);
    }
  }
}

// ---- the tensor-core loop: x and w in one 2-byte type ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8x8 matrices of 2-byte elements; lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes each, 16-byte aligned).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row-major) @ b (16 x 8, column-major), f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A group's four warps tile BM x 64 as WM x WN warps, each warp MI m16
// fragments by NI n8 fragments.  The ring, its loaders, the K groups'
// split of each slab, the group sum, split-K and the rounding are the
// CUDA-core loop's; only the fragment reads and the products differ.
// Per k16 step a warp issues MI + NI/2 ldmatrix and MI * NI mma for
// MI * NI * 2048 products; on CUDA cores a warp instruction is 32 FMAs,
// after a shared load and a conversion per element.
// (One block an SM in the bound: ptxas then keeps every instance free
// of spills.)
template <int BM, int BK, int MI, int KG, int STAGES, bool K1, bool AVEC,
          bool BVEC, typename T>
__global__ void __launch_bounds__(kGroup* KG, 1)
    mma_kernel(const __grid_constant__ Problem<T, T, T> p) {
  static_assert(sizeof(T) == 2, "bf16 or fp16 operands");
  constexpr int THREADS = kGroup * KG;
  constexpr int BN = kBN;
  constexpr int KS = BK / KG;  // slab depth of one group
  static_assert(KS % 16 == 0, "a group takes whole k16 steps");
  constexpr int WM = BM / (16 * MI);  // warps along M
  static_assert(WM >= 1 && WM * 16 * MI == BM && 4 % WM == 0,
                "four warps tile the block's rows");
  constexpr int WN = 4 / WM;          // warps along N
  constexpr int NI = BN / (8 * WN);   // n8 fragments of a warp
  static_assert(NI % 2 == 0 && NI * 8 * WN == BN,
                "B fragments load two n8 columns at a time");
  constexpr int AST = kAStride<BK, T>;
  constexpr int BST = kBStride<true, T>;
  constexpr int A_BYTES = BM * AST * (int)sizeof(T);
  constexpr int B_BYTES = BK * BST * (int)sizeof(T);
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0,
                "every stage buffer starts 16-byte aligned");
  constexpr int RING = STAGES * (A_BYTES + B_BYTES);
  // the ring, or at the end the KG-1 parked f32 group tiles
  constexpr int PARK = (KG - 1) * BM * BN * (int)sizeof(float);
  __shared__ __align__(16) unsigned char smem[RING > PARK ? RING : PARK];
  __shared__ int rowh[BM], roww[BM];
  __shared__ long long rowoff[BM];
  T* const As = reinterpret_cast<T*>(smem);  // [STAGES][BM * AST]
  T* const Bs =
      reinterpret_cast<T*>(smem + STAGES * A_BYTES);  // [STAGES][BK * BST]

  const int tid = threadIdx.x;
  const int kg = tid / kGroup;
  const int lane = tid % 32, warp = tid % kGroup / 32;
  const int wr = warp / WN * 16 * MI;  // the warp's first row in the tile
  const int wc = warp % WN * 8 * NI;   // and its first column
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.kchunk;
  const int ke = min(p.Kdim, kb + p.kchunk);
  const int nslab = (ke - kb + BK - 1) / BK;

  set_rows<BM, THREADS>(p, m0, rowh, roww, rowoff, tid);
  __syncthreads();
  wait_prior_grid();
  release_dependents();

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab)
      load_slab<BM, BN, BST, BK, THREADS, K1, AVEC, BVEC>(
          p, rowh, roww, rowoff, As + s * BM * AST, Bs + s * BK * BST,
          kb + s * BK, ke, n0, tid);
    cp_async_commit();
  }
  // lane l reads A rows l % 16 at column block l / 16, and B k-rows
  // l % 16 at n8 block l / 16: the four 8x8 matrices of an m16k16 A
  // fragment, and (transposed) of two k16n8 B fragments
  const T* const a_lane = As + (wr + (lane & 15)) * AST + (lane >> 4) * 8;
  const T* const b_lane = Bs + (lane & 15) * BST + wc + (lane >> 4) * 8;
  for (int t = 0; t < nslab; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab t landed for all; stage (t-1) % STAGES is free
    const int nxt = t + STAGES - 1;
    if (nxt < nslab)
      load_slab<BM, BN, BST, BK, THREADS, K1, AVEC, BVEC>(
          p, rowh, roww, rowoff, As + (nxt % STAGES) * BM * AST,
          Bs + (nxt % STAGES) * BK * BST, kb + nxt * BK, ke, n0, tid);
    cp_async_commit();

    const T* as = a_lane + (t % STAGES) * BM * AST + kg * KS;
    const T* bs = b_lane + (t % STAGES) * BK * BST + kg * KS * BST;
#pragma unroll
    for (int k = 0; k < KS; k += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldsm_x4(a[i], as + i * 16 * AST + k);
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t r[4];
        ldsm_x4_t(r, bs + k * BST + j * 16);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma16816<T>(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  if constexpr (KG > 1) {
    // groups 1 .. KG-1 park their fragments in the (now idle) ring, in
    // fragment order (the same thread of every group holds the same
    // outputs); group 0 adds them in group order
    constexpr int FR = MI * NI * 4;
    float* const parked = reinterpret_cast<float*>(smem);
    const int lt = tid % kGroup;
    __syncthreads();
    if (kg > 0) {
      float* park = parked + (kg - 1) * FR * kGroup + lt;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            park[((i * NI + j) * 4 + e) * kGroup] = acc[i][j][e];
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int g = 0; g < KG - 1; ++g) {
      const float* park = parked + g * FR * kGroup + lt;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += park[((i * NI + j) * 4 + e) * kGroup];
    }
  }

  // fragment element e of lane l: row l / 4 (+8 for e >= 2), column
  // 2 * (l % 4) + e % 2
  const bool partial = p.splits > 1;
  float* const part = p.ws + (long long)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wr + i * 16 + (lane >> 2) + h * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wc + j * 8 + 2 * (lane & 3) + e;
          if (n >= p.N) continue;
          const float v = acc[i][j][2 * h + e];
          if (partial)
            part[(long long)m * p.N + n] = v;
          else
            p.out[m * p.ldo + n] = from_f32<T>(v);
        }
    }
}

// out[m, n] = sum over s = 0 .. splits-1, in that order, of ws[s, m, n],
// rounded once to TO; 4 consecutive outputs a thread (vec: M*N and ldo
// multiples of 4, out aligned to 4 outputs)
template <bool VEC, typename TO>
__global__ void __launch_bounds__(256)
    splitk_reduce(const float* __restrict__ ws, TO* __restrict__ out, int M,
                  int N, long long ldo, int splits) {
  wait_prior_grid();
  release_dependents();
  const long long mn = (long long)M * N;
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       i < mn; i += 4LL * gridDim.x * blockDim.x) {
    if constexpr (VEC) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int k = 0; k < splits; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(ws + k * mn + i);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const long long m = i / N;
      store4(out + m * ldo + (i - m * N), s);
    } else {
      for (long long e = i; e < i + 4 && e < mn; ++e) {
        float s = 0.f;
#pragma unroll 8
        for (int k = 0; k < splits; ++k) s += ws[k * mn + e];
        const long long m = e / N;
        out[m * ldo + (e - m * N)] = from_f32<TO>(s);
      }
    }
  }
}

template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, int threads,
                       cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// One tile config on its loop: MMA picks mma_kernel (TM is then MI, the
// m16 fragments of a warp), else gemm_kernel.
template <bool MMA, int BM, int BK, int TM, int KG, int STAGES, bool K1,
          bool AVEC, bool BVEC, typename TX, typename TW, typename TO>
cudaError_t launch_one(const Problem<TX, TW, TO>& p, dim3 grid,
                       cudaStream_t st) {
  constexpr int THREADS = kGroup * KG;
  if constexpr (MMA)
    return launch_pdl(
        mma_kernel<BM, BK, TM, KG, STAGES, K1, AVEC, BVEC, TX>, grid,
        THREADS, st, p);
  else
    return launch_pdl(
        gemm_kernel<BM, BK, TM, KG, STAGES, K1, AVEC, BVEC, TX, TW, TO>,
        grid, THREADS, st, p);
}

template <bool MMA, int BM, int BK, int TM, int KG, int STAGES, bool K1,
          typename TX, typename TW, typename TO>
cudaError_t launch_tiles(const Problem<TX, TW, TO>& p, bool avec, bool bvec,
                         dim3 grid, cudaStream_t st) {
  if (avec && bvec)
    return launch_one<MMA, BM, BK, TM, KG, STAGES, K1, true, true>(
        p, grid, st);
  if (avec)
    return launch_one<MMA, BM, BK, TM, KG, STAGES, K1, true, false>(
        p, grid, st);
  if (bvec)
    return launch_one<MMA, BM, BK, TM, KG, STAGES, K1, false, true>(
        p, grid, st);
  return launch_one<MMA, BM, BK, TM, KG, STAGES, K1, false, false>(
      p, grid, st);
}

template <bool MMA, int BM, int BK, int TM, int KG, int STAGES,
          typename TX, typename TW, typename TO>
int launch_cfg(const Problem<TX, TW, TO>& p, bool avec, bool bvec,
               cudaStream_t st) {
  if (p.kchunk % BK != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p.N + kBN - 1) / kBN),
                  (unsigned)((p.M + BM - 1) / BM), (unsigned)p.splits);
  const cudaError_t err =
      p.K == 1
          ? launch_tiles<MMA, BM, BK, TM, KG, STAGES, true>(p, avec, bvec,
                                                           grid, st)
          : launch_tiles<MMA, BM, BK, TM, KG, STAGES, false>(p, avec, bvec,
                                                            grid, st);
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long mn = (long long)p.M * p.N;
  const long long blocks = (mn + 1023) / 1024;
  const dim3 rgrid((unsigned)(blocks < 1056 ? blocks : 1056));
  const bool vec =
      mn % 4 == 0 && p.ldo % 4 == 0 && p.N % 4 == 0 &&
      reinterpret_cast<uintptr_t>(p.out) % (4 * sizeof(TO)) == 0;
  return (int)(vec ? launch_pdl(splitk_reduce<true, TO>, rgrid, 256, st,
                                p.ws, p.out, p.M, p.N, p.ldo, p.splits)
                   : launch_pdl(splitk_reduce<false, TO>, rgrid, 256, st,
                                p.ws, p.out, p.M, p.N, p.ldo, p.splits));
}

// x, w and out in one 2-byte type: the pairs the tensor-core loop takes
template <typename TX, typename TW, typename TO>
constexpr bool kMmaPair = std::is_same_v<TX, TW> && std::is_same_v<TX, TO> &&
                          sizeof(TX) == 2;

// A CUDA-core config <BM, BK, TM, KG, STAGES>: f32 and mixed pairs only.
template <int BM, int BK, int TM, int KG, int STAGES, typename TX,
          typename TW, typename TO>
int fma_cfg(const Problem<TX, TW, TO>& p, bool avec, bool bvec,
            cudaStream_t st) {
  if constexpr (kMmaPair<TX, TW, TO>)
    return (int)cudaErrorInvalidValue;
  else
    return launch_cfg<false, BM, BK, TM, KG, STAGES>(p, avec, bvec, st);
}

// A tensor-core config <BM, BK, MI, KG, STAGES>: same-type 2-byte pairs
// only.
template <int BM, int BK, int MI, int KG, int STAGES, typename TX,
          typename TW, typename TO>
int mma_cfg(const Problem<TX, TW, TO>& p, bool avec, bool bvec,
            cudaStream_t st) {
  if constexpr (kMmaPair<TX, TW, TO>)
    return launch_cfg<true, BM, BK, MI, KG, STAGES>(p, avec, bvec, st);
  else
    return (int)cudaErrorInvalidValue;
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Checks the split and the routes' preconditions, then launches the tile
// loop (and the split-K reduction when splits > 1) on `st`.
template <typename TX, typename TW, typename TO>
int launch(const Problem<TX, TW, TO>& p, int cfg, int avec, int bvec,
           cudaStream_t st) {
  if (p.M <= 0 || p.N <= 0 || p.Kdim <= 0 || p.splits < 1 ||
      p.kchunk <= 0 || (long long)(p.splits - 1) * p.kchunk >= p.Kdim ||
      (long long)p.splits * p.kchunk < p.Kdim || p.splits > 65535 ||
      (p.splits > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int EA = kVec<TX>, EB = kVec<TW>;
  if (avec && (p.Cin % EA || !aligned16(p.x) || p.sxh % EA || p.sxw % EA))
    return (int)cudaErrorInvalidValue;
  if (bvec && (p.swo != 1 || !aligned16(p.w) || p.swi % EB ||
               p.sww % EB || p.swh % EB))
    return (int)cudaErrorInvalidValue;
  // cfg: the tile config, kernels/gemm.py's CONFIGS[cfg]
  switch (cfg) {
    case 0:  // CUDA cores, 32 x 64, 4 K groups: conv shards, many pixels
      return fma_cfg<32, 32, 4, 4, 3>(p, avec, bvec, st);
    case 1:  // CUDA cores, 32 x 64, 2 K groups: FC, conv of <= 32 pixels
      return fma_cfg<32, 32, 4, 2, 3>(p, avec, bvec, st);
    case 2:  // CUDA cores, 8 x 64, 4 K groups: M <= 8, GEMV-like
      return fma_cfg<8, 32, 1, 4, 3>(p, avec, bvec, st);
    case 3:  // tensor cores, 32 x 64, 2 K groups: M > 16
      return mma_cfg<32, 64, 2, 2, 3>(p, avec, bvec, st);
    case 4:  // tensor cores, 16 x 64, 2 K groups: M <= 16
      return mma_cfg<16, 64, 1, 2, 3>(p, avec, bvec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gemm_f32
