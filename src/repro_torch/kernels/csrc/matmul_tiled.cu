// matmul_tiled for Hopper (sm_90a): out[M, N] = x[M, K] @ w[K, N] in f32
// with f32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ops.py::matmul_tiled
// (body _matmul_kernel), the engine's FC shard kernel.  The product is
// computed in this kernel's own body; no library GEMM is called.  Rows
// and columns are addressed through leading dimensions (unit column
// stride), so the plan's OutC column slice w[:, c0:c1] is read in place.
//
// What bounds it on the H100: the FC shards of the main path are skinny.
// bert-base's INH plan gives [32, K] @ [K, N] at 4 nodes (K, N in 768,
// 2304, 3072): 2*32*K*N flops on 4*K*N weight bytes, 16 flop/byte, below
// the f32 ridge of 67 TFLOP/s over 3.35 TB/s (~20), so the work is
// streaming the weight.  The classifier heads ([1, K] @ [K, 250] column
// views) are GEMVs, bound by bytes too.
//
// The design: a weight-streaming skinny GEMM, the 1x1 case of the shared
// implicit-GEMM tile loop in gemm_f32.cuh over an [M, 1, K] map.  Each
// block owns up to 32 rows x 64 columns and one K chunk; the grid is N
// tiles x split-K chunks, sized by the caller (repro_torch/kernels/gemm.py)
// to about three waves over the 132 SMs, so a [32, 768] @ [768, 2304]
// shard runs 36 x 8 blocks.  x and w slabs stream through a 3-stage
// cp.async ring (16-byte copies where the pointer and leading dimension
// allow, 4-byte otherwise: an odd node's head view starts 1000 bytes past
// a 16-byte boundary).  Each thread keeps a 4x4 register tile (1x4 for
// M <= 8), and two or four groups of 128 threads split every slab's depth,
// so a block has 8 or 16 warps on one tile.  Split-K partial tiles go to
// an f32 workspace and a second pass sums them in a fixed order:
// deterministic, no atomics.
//
// Build: see repro_torch/kernels/build.py.  Plain C interface; the entry
// point launches on the given stream and returns cudaGetLastError().

#include "gemm_f32.cuh"

extern "C" int matmul_tiled_f32(const float* x, const float* w, float* out,
                                float* ws, int M, int N, int K,
                                long long ldx, long long ldw, long long ldo,
                                int cfg, int splits, int kchunk, int avec,
                                int bvec, void* stream) {
  gemm_f32::Problem p;
  p.x = x;
  p.w = w;
  p.out = out;
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
