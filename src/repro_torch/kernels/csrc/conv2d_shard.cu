// conv2d_shard for Hopper (sm_90a): one conv shard over the NT-mode local
// slice, f32 in, f32 accumulation, f32 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv2d.py::conv2d_shard
// (body _shard_kernel).  Like it, the kernel consumes the node's raw local
// slice (own rows plus halo rows) in place and applies the graph-boundary
// zero padding on chip: a tap that falls outside [0, Hl) x [0, Wl) reads 0
// (the TPU kernel's VMEM scratch fill), so no padded copy of the feature
// map is written to device memory.  The input is addressed through its row
// and column strides (channel stride 1) and the weight through all four of
// its strides, so the engine's strided halo slice x[r0:r1, c0:c1, :] and an
// OutC shard's weight view w[..., c0:c1] are read without a copy.
//
// What bounds it on the H100: the dense layers of the edge models do
// 2*Cin*K*K flops per output element.  On the main path (4 nodes, INH
// row shards) they are small: ResNet-18's late 3x3 512->512 shards have
// 7-14 output pixels against K*K*Cin = 4608, its 3x3 64->64 shards 784
// pixels, the Cin = 3 stems K*K*Cin = 27 and 147.  Alone, each call is
// bound by the bytes it moves; over a pass, by how many launches fit in
// the time.
//
// The design: an implicit GEMM, the shared tile loop in gemm_f32.cuh.
// M = the shard's output pixels, K = (kh, kw, ci) flattened, N = the Cout
// slice.  32 x 64 block tiles (8 x 64 for shards of at most 8 pixels;
// chosen per call by repro_torch/kernels/gemm.py), with 32-deep slabs of
// the implicit im2col tile and the weight staged through a 3-stage
// cp.async ring in shared memory, 4x4 register tiles, and four groups of
// 128 threads splitting each slab's depth (two for shards of 9-32
// pixels).  The graph-boundary pads are zero-fill when the A tile is filled (a
// cp.async with source size 0), the counterpart of the TPU kernel's
// zero-filled VMEM scratch: no padded copy exists in device memory.  The
// slab runs over the flattened (kh, kw, ci) index, so the Cin = 3 stems
// waste no lanes.  Where M tiles x N tiles would leave the card
// under-filled, the K loop is split into chunks whose partial tiles a
// second pass sums in a fixed order (deterministic, no atomics).  The
// load width is chosen per call from alignment: 16-byte copies along the
// channels where Cin % 4 == 0 and the view is aligned, 4-byte otherwise.
//
// Depthwise layers do 2*K*K flops per output element and are bound by
// bytes; their kernel gives each thread one (ho, wo, c) output with c
// fastest, so every tap is a coalesced load (neighbouring taps hit L1).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).  Plain C
// interface; each entry point launches on the given stream and returns
// cudaGetLastError() right after the launch.

#include "gemm_f32.cuh"

namespace {

constexpr int DW_THREADS = 256;

__global__ void conv_dw_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, int Hl, int Wl, int C, int K, int S, int pt,
    int pl, int Ho, int Wo, long long sxh, long long sxw, long long swh,
    long long sww, long long swc) {
  const long long idx = (long long)blockIdx.x * DW_THREADS + threadIdx.x;
  const long long total = (long long)Ho * Wo * C;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long p = idx / C;
  const int ho = (int)(p / Wo);
  const int wo = (int)(p % Wo);
  const int h0 = ho * S - pt;
  const int w0 = wo * S - pl;
  float acc = 0.f;
  for (int kh = 0; kh < K; ++kh) {
    const int hi = h0 + kh;
    if (hi < 0 || hi >= Hl) continue;  // zero pad row
    for (int kw = 0; kw < K; ++kw) {
      const int wi = w0 + kw;
      if (wi < 0 || wi >= Wl) continue;  // zero pad column
      acc = fmaf(x[hi * sxh + wi * sxw + c], w[kh * swh + kw * sww + c * swc],
                 acc);
    }
  }
  out[idx] = acc;
}

}  // namespace

extern "C" int conv2d_shard_dense_f32(
    const float* x, const float* w, float* out, float* ws, int Hl, int Wl,
    int Cin, int Cout, int K, int S, int pt, int pl, int Ho, int Wo,
    long long sxh, long long sxw, long long swh, long long sww,
    long long swi, long long swo, int cfg, int splits, int kchunk, int avec,
    int bvec, void* stream) {
  gemm_f32::Problem p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.ws = ws;
  p.M = Ho * Wo;
  p.N = Cout;
  p.Kdim = K * K * Cin;
  p.Hl = Hl;
  p.Wl = Wl;
  p.Cin = Cin;
  p.K = K;
  p.S = S;
  p.pt = pt;
  p.pl = pl;
  p.Wo = Wo;
  p.sxh = sxh;
  p.sxw = sxw;
  p.swh = swh;
  p.sww = sww;
  p.swi = swi;
  p.swo = swo;
  p.ldo = Cout;
  p.kchunk = kchunk;
  p.splits = splits;
  const int rc = gemm_f32::launch(p, cfg, avec, bvec, (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}

extern "C" int conv2d_shard_dw_f32(
    const float* x, const float* w, float* out, int Hl, int Wl, int C, int K,
    int S, int pt, int pl, int Ho, int Wo, long long sxh, long long sxw,
    long long swh, long long sww, long long swc, void* stream) {
  const long long total = (long long)Ho * Wo * C;
  dim3 grid((unsigned)((total + DW_THREADS - 1) / DW_THREADS));
  conv_dw_kernel<<<grid, DW_THREADS, 0, (cudaStream_t)stream>>>(
      x, w, out, Hl, Wl, C, K, S, pt, pl, Ho, Wo, sxh, sxw, swh, sww, swc);
  return (int)cudaGetLastError();
}
