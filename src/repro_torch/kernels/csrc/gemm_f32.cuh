// Shared f32 implicit-GEMM tile loop for Hopper (sm_90a), included by
// conv2d_shard.cu and matmul_tiled.cu.
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
// The loop: a block owns a BM x 64 output tile and one K chunk of
// `kchunk` (a multiple of BK).  BK-deep slabs of A and B stream through a
// 3-stage cp.async ring in shared memory: while the block computes on
// slab t, slabs t+1 and t+2 are in flight.  A pad tap or a ragged edge is
// a cp.async with source size 0, which fills the shared-memory tile with
// zeros without touching device memory.  Each thread keeps a TM x 4
// register tile, so one float4 of B read from shared memory feeds 4*TM
// FMAs; KG groups of 128 threads split each slab's depth and add their
// tiles in shared memory at the end, in group order.  A 1x1 conv or FC
// shard (K == 1) takes a one-tap path: each row's x offset is set once
// per block and k is the channel, so the loaders do no tap arithmetic.
// f32 in, f32 FMA on CUDA cores, f32 out: no tensor cores, no TF32.
//
// Split-K: with splits > 1 the blocks of chunk s write their partial tile
// to ws[s, M, N] (an f32 workspace the caller allocates) and a second
// pass sums the splits in the fixed order 0, 1, ..., splits-1.  No atomics:
// the same call gives the same bits every time.  Both passes are launched
// as programmatic dependents (Hopper), so each one's launch overlaps the
// tail of the kernel before it.
//
// Routes, chosen by the caller from alignment: AVEC loads A as 16-byte
// cp.async.cg (4 channels; needs Cin % 4 == 0, a 16-byte aligned x and row
// and column strides that are multiples of 4), else 4-byte cp.async.ca;
// BVEC loads B as 16-byte copies along n (needs unit output-channel
// stride, a 16-byte aligned w and the other strides multiples of 4), else
// 4-byte copies.  The launcher re-checks each precondition and returns
// cudaErrorInvalidValue rather than launch a misaligned copy.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace gemm_f32 {

struct Problem {
  const float* x;
  const float* w;
  float* out;
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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
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

__device__ __forceinline__ Tap tap_of(const Problem& p, int tap0, int kh0,
                                      int kw0, int ci0, int d) {
  int ci = ci0 + d;
  if (ci < p.Cin) return {kh0, kw0, ci};
  const int q = ci / p.Cin;
  const int tap = tap0 + q;
  ci -= q * p.Cin;
  const int kh = tap / p.K;
  return {kh, tap - kh * p.K, ci};
}

// Issues the cp.async copies of one slab, flattened K index k0 .. k0+BK-1
// (only those below ke are live), into the stage buffers as / bs.  The
// slab's first tap is decomposed once; a row inside it costs one add.
template <int BM, int BN, int BK, int THREADS, bool K1, bool AVEC, bool BVEC>
__device__ __forceinline__ void load_slab(const Problem& p, const int* rowh,
                                          const int* roww,
                                          const long long* rowoff, float* as,
                                          float* bs, int k0, int ke, int n0,
                                          int tid) {
  constexpr int AST = BK + 4;
  // a 1x1 conv (or FC) has one tap: k is the channel, no decomposition
  const int tap0 = K1 ? 0 : k0 / p.Cin;
  const int ci0 = K1 ? k0 : k0 - tap0 * p.Cin;
  const int kh0 = K1 ? 0 : tap0 / p.K;
  const int kw0 = K1 ? 0 : tap0 - kh0 * p.K;
  // A: BM rows x BK flattened (kh, kw, ci); consecutive threads take
  // consecutive channels of one row
  constexpr int AW = AVEC ? 4 : 1;  // floats per copy
  constexpr int ACPR = BK / AW;     // copies per row
  for (int c = tid; c < BM * ACPR; c += THREADS) {
    const int r = c / ACPR, d = (c % ACPR) * AW;
    bool ok;
    const float* src;
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
      cp_async4(as + r * AST + d, src, ok ? 4 : 0);
  }
  // B: BK rows x BN output channels; consecutive threads take consecutive
  // channels of one row
  const float* w0 = p.w + kh0 * p.swh + kw0 * p.sww + ci0 * p.swi;
  constexpr int BW = BVEC ? 4 : 1;
  constexpr int BCPR = BN / BW;
  for (int c = tid; c < BK * BCPR; c += THREADS) {
    const int d = c / BCPR, n = (c % BCPR) * BW;
    const int gn = n0 + n;
    const float* row;
    if (K1 || ci0 + d < p.Cin) {
      row = w0 + d * p.swi;
    } else {
      const Tap tp = tap_of(p, tap0, kh0, kw0, ci0, d);
      row = p.w + tp.kh * p.swh + tp.kw * p.sww + tp.ci * p.swi;
    }
    if constexpr (BVEC) {
      const int live = k0 + d < ke ? min(4, max(0, p.N - gn)) : 0;
      cp_async16(bs + d * BN + n, live ? row + gn : p.w, 4 * live);
    } else {
      const bool ok = k0 + d < ke && gn < p.N;
      cp_async4(bs + d * BN + n, ok ? row + gn * p.swo : p.w, ok ? 4 : 0);
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

template <int BM, int BK, int TM, int KG, int STAGES, bool K1, bool AVEC,
          bool BVEC>
__global__ void __launch_bounds__(kGroup* KG)
    gemm_kernel(const __grid_constant__ Problem p) {
  constexpr int THREADS = kGroup * KG;
  constexpr int BN = kBN;
  constexpr int KS = BK / KG;  // slab depth of one group
  static_assert(kTX * (BM / TM) == kGroup, "tile does not match threads");
  static_assert(KS % 4 == 0, "a group takes whole float4 steps");
  constexpr int AST = BK + 4;  // A row stride in floats (16-byte rows)
  // the stage ring, or at the end the KG-1 parked tiles of the group sum
  constexpr int RING = STAGES * (BM * AST + BK * BN);
  constexpr int PARK = (KG - 1) * BM * BN;
  __shared__ __align__(16) float smem[RING > PARK ? RING : PARK];
  __shared__ int rowh[BM], roww[BM];
  __shared__ long long rowoff[BM];  // K1: x offset of the row's one tap
  float* const As = smem;                      // [STAGES][BM * AST]
  float* const Bs = smem + STAGES * BM * AST;  // [STAGES][BK * BN]

  const int tid = threadIdx.x;
  const int kg = tid / kGroup;
  const int tx = tid % kTX, ty = tid % kGroup / kTX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.kchunk;
  const int ke = min(p.Kdim, kb + p.kchunk);
  const int nslab = (ke - kb + BK - 1) / BK;

  // top-left input tap of each output row of the tile; rows past M get a
  // row index that fails every bound check (K1: offset -1 for a row past
  // M or a tap in the pads)
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
      load_slab<BM, BN, BK, THREADS, K1, AVEC, BVEC>(
          p, rowh, roww, rowoff, As + s * BM * AST, Bs + s * BK * BN,
          kb + s * BK, ke, n0, tid);
    cp_async_commit();
  }
  for (int t = 0; t < nslab; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab t landed for all; stage (t-1) % STAGES is free
    const int nxt = t + STAGES - 1;
    if (nxt < nslab)
      load_slab<BM, BN, BK, THREADS, K1, AVEC, BVEC>(
          p, rowh, roww, rowoff, As + (nxt % STAGES) * BM * AST,
          Bs + (nxt % STAGES) * BK * BN, kb + nxt * BK, ke, n0, tid);
    cp_async_commit();

    const float* as = As + (t % STAGES) * BM * AST + ty * TM * AST + kg * KS;
    const float* bs = Bs + (t % STAGES) * BK * BN + kg * KS * BN + tx * 4;
#pragma unroll
    for (int k = 0; k < KS; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + i * AST + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(bs + (k + q) * BN);
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
    __syncthreads();
    if (kg > 0) {
      float* park = smem + (kg - 1) * BM * BN + ty * TM * BN + tx * 4;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(park + i * BN) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int g = 0; g < KG - 1; ++g) {
      const float* park = smem + g * BM * BN + ty * TM * BN + tx * 4;
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

  float* dst = p.out;
  long long ld = p.ldo;
  if (p.splits > 1) {
    dst = p.ws + (long long)blockIdx.z * p.M * p.N;
    ld = p.N;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.N) dst[m * ld + n] = acc[i][j];
    }
  }
}

// out[m, n] = sum over s = 0 .. splits-1, in that order, of ws[s, m, n];
// 4 consecutive outputs a thread (vec: M*N and ldo multiples of 4, out
// 16-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(256)
    splitk_reduce(const float* __restrict__ ws, float* __restrict__ out,
                  int M, int N, long long ldo, int splits) {
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
      *reinterpret_cast<float4*>(out + m * ldo + (i - m * N)) = s;
    } else {
      for (long long e = i; e < i + 4 && e < mn; ++e) {
        float s = 0.f;
#pragma unroll 8
        for (int k = 0; k < splits; ++k) s += ws[k * mn + e];
        const long long m = e / N;
        out[m * ldo + (e - m * N)] = s;
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

template <int BM, int BK, int TM, int KG, int STAGES, bool K1>
cudaError_t launch_tiles(const Problem& p, bool avec, bool bvec, dim3 grid,
                         cudaStream_t st) {
  constexpr int THREADS = kGroup * KG;
  if (avec && bvec)
    return launch_pdl(gemm_kernel<BM, BK, TM, KG, STAGES, K1, true, true>,
                      grid, THREADS, st, p);
  if (avec)
    return launch_pdl(gemm_kernel<BM, BK, TM, KG, STAGES, K1, true, false>,
                      grid, THREADS, st, p);
  if (bvec)
    return launch_pdl(gemm_kernel<BM, BK, TM, KG, STAGES, K1, false, true>,
                      grid, THREADS, st, p);
  return launch_pdl(gemm_kernel<BM, BK, TM, KG, STAGES, K1, false, false>,
                    grid, THREADS, st, p);
}

template <int BM, int BK, int TM, int KG, int STAGES>
int launch_cfg(const Problem& p, bool avec, bool bvec, cudaStream_t st) {
  if (p.kchunk % BK != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p.N + kBN - 1) / kBN),
                  (unsigned)((p.M + BM - 1) / BM), (unsigned)p.splits);
  const cudaError_t err =
      p.K == 1
          ? launch_tiles<BM, BK, TM, KG, STAGES, true>(p, avec, bvec, grid, st)
          : launch_tiles<BM, BK, TM, KG, STAGES, false>(p, avec, bvec, grid,
                                                        st);
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long mn = (long long)p.M * p.N;
  const long long blocks = (mn + 1023) / 1024;
  const dim3 rgrid((unsigned)(blocks < 1056 ? blocks : 1056));
  const bool vec = mn % 4 == 0 && p.ldo % 4 == 0 && p.N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  return (int)(vec ? launch_pdl(splitk_reduce<true>, rgrid, 256, st, p.ws,
                                p.out, p.M, p.N, p.ldo, p.splits)
                   : launch_pdl(splitk_reduce<false>, rgrid, 256, st, p.ws,
                                p.out, p.M, p.N, p.ldo, p.splits));
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Checks the split and the routes' preconditions, then launches the tile
// loop (and the split-K reduction when splits > 1) on `st`.
inline int launch(const Problem& p, int cfg, int avec, int bvec,
                  cudaStream_t st) {
  if (p.M <= 0 || p.N <= 0 || p.Kdim <= 0 || p.splits < 1 ||
      p.kchunk <= 0 || (long long)(p.splits - 1) * p.kchunk >= p.Kdim ||
      (long long)p.splits * p.kchunk < p.Kdim || p.splits > 65535 ||
      (p.splits > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (avec && (p.Cin % 4 || !aligned16(p.x) || p.sxh % 4 || p.sxw % 4))
    return (int)cudaErrorInvalidValue;
  if (bvec && (p.swo != 1 || !aligned16(p.w) || p.swi % 4 || p.sww % 4 ||
               p.swh % 4))
    return (int)cudaErrorInvalidValue;
  // cfg: <BM, BK, TM, KG, STAGES>
  switch (cfg) {
    case 0:  // 32 x 64, 4 K groups: conv shards with many pixels
      return launch_cfg<32, 32, 4, 4, 3>(p, avec, bvec, st);
    case 1:  // 32 x 64, 2 K groups: FC shards, conv shards of <= 32 pixels
      return launch_cfg<32, 32, 4, 2, 3>(p, avec, bvec, st);
    case 2:  // 8 x 64, 4 K groups: M <= 8, GEMV-like
      return launch_cfg<8, 32, 1, 4, 3>(p, avec, bvec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gemm_f32
