// flash_attention_bh for Hopper (sm_90a): causal and/or sliding-window
// attention out = softmax(mask(q k^T * scale)) v, streamed over key tiles
// with the online softmax, f32 accumulation, f32 or bf16 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bh (body _flash_kernel) and the head repeat and sequence
// padding of its wrapper src/repro/kernels/ops.py::flash_attention.  Both
// products (q k^T and p v) are computed in this kernel's own body; no
// library GEMM and no fused library attention.
//
// Layouts: q and out [B, H, S, hd], k and v [B, KV, S, hd], contiguous,
// H % KV == 0.  GQA is an index: query head h reads kv head h / (H / KV);
// no repeated copy of k and v exists.  Any S: keys at or past S are masked
// and query rows at or past S are not stored, so nothing is padded (the
// reference's wrapper pads S with zero keys that its non-causal kernel
// does not mask).
//
// What bounds it on the H100: operations, at the model widths.  Per head a
// causal pass over S = 2048 at hd = 128 does ~1.1 GFLOP against 4 MB of
// q/k/v/out, so the least time is the masked-in (q, k) pairs times 4 * hd
// flops over the f32 rate of the CUDA cores (67 TFLOP/s; for bf16 inputs the
// bound is taken at the 989 TFLOP/s tensor-core rate).  The design, simple
// first: one block of 256 threads per (b*h, 64-row q tile).  The q tile is
// staged once and each 64-row k and v tile through shared memory (rows
// padded by one float against bank conflicts; bf16 converted to f32 on
// load).  The score tile is 4 x 4 per thread, written to shared memory,
// masked with the reference's finite NEG_INF = -1e30 (a fully masked tile
// gives a correction of 0, never a NaN); four adjacent lanes then own one
// query row: its max and sum by shuffles, and hd / 4 accumulator columns
// in registers.  Tiles are skipped by the reference's causal upper bound
// and window lower bound.  At hd = 128 the tiles take 113 KB of shared
// memory (209 KB at hd = 256), past the 48 KB default, hence
// cudaFuncSetAttribute.  The products run on CUDA cores; tensor cores
// (mma/wgmma) are later work.
//
// Build: see repro_torch/kernels/build.py.  Plain C interface; each entry
// point launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return (size_t)(BQ * ld + 2 * BK * ld + BQ * (BK + 1)) * sizeof(float);
}

template <typename T, int HD>  // HD: the largest hd of this instance
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int H, int KV, int S,
    int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;          // padded row stride of the q/k/v tiles
  float* qs = smem;               // [BQ][ld]
  float* ks = qs + BQ * ld;       // [BK][ld]
  float* vs = ks + BK * ld;       // [BK][ld]
  float* ss = vs + BK * ld;       // [BQ][BK + 1]
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long qoff = (long long)bh * S * hd;
  const long long kvoff = (long long)(b * KV + h / (H / KV)) * S * hd;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    qs[r * ld + d] =
        q0 + r < S ? to_f32(q[qoff + (long long)(q0 + r) * hd + d]) : 0.f;
  }
  // score roles: rows ty + 16 i, columns tx + 16 j of the 64 x 64 tile
  const int ty = tid / 16, tx = tid % 16;
  // softmax and p v roles: one query row, accumulator columns part + 4 c
  const int row = tid / 4, part = tid % 4;
  constexpr int NC = HD / 4;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int nk = (S + BK - 1) / BK;
  // causal upper bound: key tiles past the diagonal contribute nothing
  const int hi = causal ? min(nk, ((qt + 1) * BQ + BK - 1) / BK) : nk;
  // window lower bound: the first tile that can reach the earliest query
  int lo = 0;
  if (window >= 0 && q0 - window > 0) lo = (q0 - window) / BK;
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int r = i / hd, d = i % hd;
      const bool in = k0 + r < S;
      const long long g = kvoff + (long long)(k0 + r) * hd + d;
      ks[r * ld + d] = in ? to_f32(k[g]) : 0.f;
      vs[r * ld + d] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bb[jj] = ks[(tx + 16 * jj) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          sc[i][jj] = fmaf(a[i], bb[jj], sc[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qi = q0 + ty + 16 * i, ki = k0 + tx + 16 * jj;
        bool valid = ki < S;
        if (causal) valid = valid && ki <= qi;
        if (window >= 0) valid = valid && ki > qi - window;
        ss[(ty + 16 * i) * (BK + 1) + tx + 16 * jj] =
            valid ? sc[i][jj] * scale : NEG_INF;
      }
    }
    __syncthreads();
    float* srow = ss + row * (BK + 1);
    float mx = NEG_INF;
    for (int c = part; c < BK; c += 4) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
    for (int c = part; c < BK; c += 4) {
      const float p = expf(srow[c] - m_new);
      srow[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // the row's p values come from the four lanes of this row
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = srow[kk];
      const float* vrow = vs + kk * ld + part;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (part + 4 * c < hd) acc[c] = fmaf(p, vrow[4 * c], acc[c]);
    }
  }
  if (q0 + row < S) {
    T* orow = out + qoff + (long long)(q0 + row) * hd;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (part + 4 * c < hd) store(orow + part + 4 * c, acc[c] / den);
  }
}

template <typename T, int HD>
int launch(const T* q, const T* k, const T* v, T* out, int B, int H, int KV,
           int S, int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  // raise the instance's shared-memory limit once, at its largest hd, so
  // later launches (a CUDA graph capture included) make no attribute call
  static bool limit_set = false;
  if (!limit_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(HD));
    if (err != cudaSuccess) return (int)err;
    limit_set = true;
  }
  const size_t smem = smem_bytes(hd);
  dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * H));
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, H, KV, S, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, int B, int H,
             int KV, int S, int hd, int causal, int window, float scale,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, H, KV, S, hd, causal, window,
                         scale, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, B, H, KV, S, hd, causal, window,
                          scale, s);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, out, B, H, KV, S, hd, causal, window,
                          scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int B, int H,
                                   int KV, int S, int hd, int causal,
                                   int window, float scale, void* stream) {
  return dispatch(q, k, v, out, B, H, KV, S, hd, causal, window, scale,
                  stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int KV, int S, int hd, int causal,
                                    int window, float scale, void* stream) {
  using bf = __nv_bfloat16;
  return dispatch((const bf*)q, (const bf*)k, (const bf*)v, (bf*)out, B, H,
                  KV, S, hd, causal, window, scale, stream);
}
