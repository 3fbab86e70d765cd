// matmul_tiled for Hopper (sm_90a): out[M, N] = x[M, K] @ w[K, N] with f32
// accumulation, the output in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ops.py::matmul_tiled
// (body _matmul_kernel), the engine's FC shard kernel.  The product is
// computed in this kernel's own body; no library GEMM is called.  Rows
// and columns are addressed through leading dimensions (unit column
// stride), so the plan's OutC column slice w[:, c0:c1] is read in place.
//
// What bounds it on the H100: the FC shards of the main path are skinny.
// bert-base's INH plan gives [32, K] @ [K, N] at 4 nodes (K, N in 768,
// 2304, 3072): 2*32*K*N flops on 4*K*N weight bytes in f32, 16 flop/byte,
// below the f32 ridge of 67 TFLOP/s over 3.35 TB/s (~20), so in f32 the
// work is streaming the weight.  In bf16 the weight is 2*K*N bytes, 32
// flop/byte, an order of magnitude below the tensor cores' ridge (~295):
// still bytes, not products, as long as the products run on the tensor
// cores; on CUDA cores the same call is bound by issuing its FMAs, loads
// and conversions (halving the bytes moved it under 1%).  The classifier
// heads ([1, K] @ [K, 250] column views) are GEMVs, bound by bytes too.
//
// The design: a weight-streaming skinny GEMM, the 1x1 case of the shared
// implicit-GEMM tile loop in gemm_f32.cuh over an [M, 1, K] map.  Each
// block owns up to 32 rows x 64 columns and one K chunk; the grid is N
// tiles x split-K chunks, sized by the caller (repro_torch/kernels/gemm.py)
// to the config's number of waves over the 132 SMs.  x and w slabs stream
// through a 3-stage cp.async ring (16-byte copies where the pointer and
// leading dimension allow, one element a copy otherwise: an odd node's
// head view starts 1000 bytes past a 16-byte boundary), and two or four
// groups of 128 threads split every slab's depth.  Two compute loops read
// the ring:
//
// * x and w in one 2-byte type (_bf16, _f16): the tensor-core loop, each
//   warp's fragments read by ldmatrix and multiplied by mma.sync.m16n8k16
//   with f32 accumulators (a 32 x 16 or 16 x 16 warp tile);
// * f32 and a 2-byte x with f32 weights (_f32, _bf16_f32, _f16_f32): the
//   CUDA-core loop, each thread a 4x4 register tile (1x4 for M <= 8) of
//   f32 FMAs on elements converted to f32 where they are read.
//
// Split-K partial tiles go to an f32 workspace and a second pass sums
// them in a fixed order: deterministic, no atomics.
//
// Types: as the TPU kernel, which casts both operands to f32 and writes
// x.dtype: products exact in f32 (a bf16 or fp16 product is exact in f32
// on the tensor cores), the sum f32, and the output rounded once to x's
// type (round to nearest even).  Entry points by (x, w) type, as
// conv2d_shard.cu's: _f32, _bf16, _f16, _bf16_f32, _f16_f32.  In a 2-byte
// type a 16-byte copy is 8 elements, and an unaligned view takes plain
// 2-byte loads.
//
// Build: see repro_torch/kernels/build.py.  Plain C interface; the entry
// point launches on the given stream and returns cudaGetLastError().

#include "gemm_f32.cuh"

namespace {

template <typename TX, typename TW>
int matmul(const void* x, const void* w, void* out, float* ws, int M, int N,
           int K, long long ldx, long long ldw, long long ldo, int cfg,
           int splits, int kchunk, int avec, int bvec, void* stream) {
  gemm_f32::Problem<TX, TW, TX> p;
  p.x = static_cast<const TX*>(x);
  p.w = static_cast<const TW*>(w);
  p.out = static_cast<TX*>(out);
  p.ws = ws;
  p.M = M;
  p.N = N;
  p.Kdim = K;
  // the [M, 1, K] map of a 1x1 conv: row m is output pixel (m, 0)
  p.Hl = M;
  p.Wl = 1;
  p.Cin = K;
  p.K = 1;
  p.S = 1;
  p.pt = 0;
  p.pl = 0;
  p.Wo = 1;
  p.sxh = ldx;
  p.sxw = 0;
  p.swh = 0;
  p.sww = 0;
  p.swi = ldw;
  p.swo = 1;
  p.ldo = ldo;
  p.kchunk = kchunk;
  p.splits = splits;
  const int rc = gemm_f32::launch(p, cfg, avec, bvec, (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace

// The entry points: matmul_tiled_<suffix> for x of type TX and w of type
// TW, the output in TX.
#define MATMUL_PARAMS                                                        \
  const void *x, const void *w, void *out, float *ws, int M, int N, int K,   \
      long long ldx, long long ldw, long long ldo, int cfg, int splits,      \
      int kchunk, int avec, int bvec, void *stream
#define MATMUL_ARGS                                                          \
  x, w, out, ws, M, N, K, ldx, ldw, ldo, cfg, splits, kchunk, avec, bvec,    \
      stream

extern "C" int matmul_tiled_f32(MATMUL_PARAMS) {
  return matmul<float, float>(MATMUL_ARGS);
}
extern "C" int matmul_tiled_bf16(MATMUL_PARAMS) {
  return matmul<__nv_bfloat16, __nv_bfloat16>(MATMUL_ARGS);
}
extern "C" int matmul_tiled_f16(MATMUL_PARAMS) {
  return matmul<__half, __half>(MATMUL_ARGS);
}
extern "C" int matmul_tiled_bf16_f32(MATMUL_PARAMS) {
  return matmul<__nv_bfloat16, float>(MATMUL_ARGS);
}
extern "C" int matmul_tiled_f16_f32(MATMUL_PARAMS) {
  return matmul<__half, float>(MATMUL_ARGS);
}
