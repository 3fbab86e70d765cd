// matmul_tiled for Hopper (sm_90a): out[M, N] = x[M, K] @ w[K, N] in f32
// with f32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ops.py::matmul_tiled
// (body _matmul_kernel), the engine's FC shard kernel.  The product is
// computed in this kernel's own body; no library GEMM is called.  Rows
// and columns are addressed through leading dimensions (unit column
// stride), so the plan's OutC column slice w[:, c0:c1] is read in place.
//
// What bounds it on the H100: the FC shapes run from the classifier heads
// (M = 1: one read of a [K, N] weight, bound by bytes at 3.35 TB/s) to
// bert-base ([128, 768] @ [768, 2304] and [128, 3072] @ [3072, 768],
// ~32 flop/byte, above the f32 ridge of ~20, so bound by the 67 TFLOP/s
// CUDA-core FMA rate).  The design: 64 x 64 output tiles per block, k
// slabs of 16 staged through shared memory so each global element is read
// once per tile, and a 4 x 4 register tile per thread so each shared load
// feeds four FMAs.  Ragged edges are masked on load (zeros) and on store.
// For M = 1 most of each tile is idle; a split-K or GEMV path, and
// wgmma/TMA pipelining for the large shapes, are later work.
//
// Build: see repro_torch/kernels/build.py.  Plain C interface; the entry
// point launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS) matmul_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, int M, int N, int K, long long ldx,
    long long ldw, long long ldo) {
  __shared__ float xs[BK][BM + 4];  // x tile stored k-major
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const int gm = row0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? x[gm * ldx + gk] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int gk = k0 + k, gn = col0 + n;
      ws[k][n] = (gk < K && gn < N) ? w[gk * ldw + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn < N) out[gm * ldo + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int matmul_tiled_f32(const float* x, const float* w, float* out,
                                int M, int N, int K, long long ldx,
                                long long ldw, long long ldo, void* stream) {
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, w, out, M, N, K, ldx, ldw, ldo);
  return (int)cudaGetLastError();
}
