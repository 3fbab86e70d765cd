// flash_decode_paged for Hopper (sm_90a): single-query (decode) attention
// over a paged KV cache, out[bh] = softmax(q[bh] . K[bh]^T * scale) V[bh]
// over the live keys of one head, in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_decode_paged (body _decode_kernel), the attention of a decode step.
// The scores and the value sum are computed in this kernel's own body; no
// library call.
//
// Layouts: q [BH, hd]; k/v pools [BH, P, ps, hd], contiguous; the page
// table [n_logical] int32 maps logical page j (keys j*ps .. j*ps + ps - 1)
// to its physical slot, and is read from device memory.  kv_len and window
// are plain int arguments (window < 0: none), so one launch serves every
// position of a decode.
//
// What it reads: the kernel walks the logical pages lo .. hi - 1 only,
// hi = ceil(kv_len / ps) and lo the window's lower bound kv_len - window
// floored to its page (as the reference does), so a page past the live
// range is never touched and the table may hold anything there.  Inside a
// page, the positions at or past kv_len or before the window are masked:
// they are skipped before any load, which gives the same sums as the
// reference's NEG_INF scores (their exp is exactly 0).
//
// What bounds it on the H100: bytes.  Every live key and value row is read
// once, and each row feeds 2 * hd flops, far below the f32 ridge of ~20
// flop/byte, so the least time is the live K/V bytes over 3.35 TB/s.  The
// design: one block per head; its 16 warps stride over the live pages, one
// warp reads one key row and the matching value row with coalesced lanes
// (hd / 32 floats a lane), reduces the score with shuffles and keeps its own
// running max, sum and accumulator (online softmax, initial max NEG_INF =
// -1e30 as in the reference, so an empty warp's correction is 0, never a
// NaN).  The warps merge their partial states in shared memory at the end.
// A decode step with 4 heads a node launches 4 blocks on 132 SMs, and each
// warp waits on one row at a time: a split-KV grid is later work.
//
// Build: see repro_torch/kernels/build.py.  Plain C interface; the entry
// point launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

template <int VPL>  // values a lane holds: ceil(hd / 32)
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const float* __restrict__ q, const float* __restrict__ kp,
    const float* __restrict__ vp, const int* __restrict__ table,
    float* __restrict__ out, int n_pages, int ps, int hd, int kv_len,
    int window, float scale) {
  extern __shared__ float smem[];
  float* s_acc = smem;                // [WARPS][hd]
  float* s_m = smem + WARPS * hd;     // [WARPS]
  float* s_l = s_m + WARPS;           // [WARPS]
  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long pool = (long long)bh * n_pages * ps * hd;

  float qr[VPL], acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < hd ? q[(long long)bh * hd + d] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const int first = window < 0 ? 0 : max(0, kv_len - window);  // first live
  const int lo = first / ps;
  const int hi = (kv_len + ps - 1) / ps;
  for (int j = lo + warp; j < hi; j += WARPS) {
    const long long base = pool + (long long)table[j] * ps * hd;
    const int r0 = max(0, first - j * ps);
    const int r1 = min(ps, kv_len - j * ps);
    for (int r = r0; r < r1; ++r) {
      const float* krow = kp + base + (long long)r * hd;
      const float* vrow = vp + base + (long long)r * hd;
      float kr[VPL], vr[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int d = lane + 32 * i;
        kr[i] = d < hd ? krow[d] : 0.f;
        vr[i] = d < hd ? vrow[d] : 0.f;
      }
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) s = fmaf(qr[i], kr[i], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] = fmaf(p, vr[i], acc[i] * corr);
      m = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) s_acc[warp * hd + d] = acc[i];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  float mx = NEG_INF;
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w]);
  float sum = 0.f;
  for (int w = 0; w < WARPS; ++w) sum += s_l[w] * expf(s_m[w] - mx);
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float o = 0.f;
    for (int w = 0; w < WARPS; ++w) o += s_acc[w * hd + d] * expf(s_m[w] - mx);
    out[(long long)bh * hd + d] = o / fmaxf(sum, 1e-30f);
  }
}

template <int VPL>
void launch(const float* q, const float* kp, const float* vp,
            const int* table, float* out, int bh, int n_pages, int ps,
            int hd, int kv_len, int window, float scale,
            cudaStream_t stream) {
  const size_t smem = (size_t)(WARPS * hd + 2 * WARPS) * sizeof(float);
  decode_kernel<VPL><<<bh, THREADS, smem, stream>>>(
      q, kp, vp, table, out, n_pages, ps, hd, kv_len, window, scale);
}

}  // namespace

extern "C" int flash_decode_paged_f32(const float* q, const float* kp,
                                      const float* vp, const int* table,
                                      float* out, int bh, int n_pages,
                                      int ps, int hd, int kv_len, int window,
                                      float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 32) {
    launch<1>(q, kp, vp, table, out, bh, n_pages, ps, hd, kv_len, window,
              scale, s);
  } else if (hd <= 64) {
    launch<2>(q, kp, vp, table, out, bh, n_pages, ps, hd, kv_len, window,
              scale, s);
  } else if (hd <= 128) {
    launch<4>(q, kp, vp, table, out, bh, n_pages, ps, hd, kv_len, window,
              scale, s);
  } else if (hd <= 256) {
    launch<8>(q, kp, vp, table, out, bh, n_pages, ps, hd, kv_len, window,
              scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
