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
// 2*Cin*K*K flops per output element against one read of the input window,
// so at full width most of them sit above the f32 ridge (67 TFLOP/s over
// 3.35 TB/s, ~20 flop/byte) and the bound is the CUDA-core FMA rate; the
// narrow early pointwise layers sit below it and are bound by bytes.
// This first kernel does not reach it: it keeps no tiles in shared memory,
// and each weight load feeds PIX FMAs (one register tile of PIX output
// pixels per thread).  Neighbouring threads take neighbouring output
// channels, so weight loads w[kh, kw, ci, co] coalesce and input loads are
// warp-wide broadcasts served from L1.  Shared-memory tiling, wgmma/TF32
// options and TMA are later work.  Depthwise layers do 2*K*K flops per
// output element and are bound by bytes; their kernel gives each thread
// one (ho, wo, c) output with c fastest, so every tap is a coalesced load.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).  Plain C
// interface; each entry point launches on the given stream and returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int CO_THREADS = 64;  // output channels per block (threadIdx.x)
constexpr int PIX_GROUPS = 4;   // pixel groups per block (threadIdx.y)
constexpr int PIX = 4;          // output pixels per thread (register tile)
constexpr int DW_THREADS = 256;

__global__ void conv_dense_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, int Hl, int Wl, int Cin, int Cout, int K,
    int S, int pt, int pl, int Ho, int Wo, long long sxh, long long sxw,
    long long swh, long long sww, long long swi, long long swo) {
  const int co = blockIdx.y * CO_THREADS + threadIdx.x;
  const long long npix = (long long)Ho * Wo;
  const long long p0 =
      ((long long)blockIdx.x * PIX_GROUPS + threadIdx.y) * PIX;
  if (co >= Cout || p0 >= npix) return;  // no barrier below: safe

  int hb[PIX], wb[PIX];
  bool pv[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const long long p = p0 + j;
    pv[j] = p < npix;
    const int ho = pv[j] ? (int)(p / Wo) : 0;
    const int wo = pv[j] ? (int)(p % Wo) : 0;
    hb[j] = ho * S - pt;
    wb[j] = wo * S - pl;
  }
  float acc[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) acc[j] = 0.f;

  for (int kh = 0; kh < K; ++kh) {
    for (int kw = 0; kw < K; ++kw) {
      const float* xp[PIX];
      bool ok[PIX];
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        const int hi = hb[j] + kh;
        const int wi = wb[j] + kw;
        // graph-boundary zero padding as a masked load
        ok[j] = pv[j] && hi >= 0 && hi < Hl && wi >= 0 && wi < Wl;
        xp[j] = ok[j] ? x + hi * sxh + wi * sxw : x;
      }
      const float* wp = w + kh * swh + kw * sww + co * swo;
      for (int ci = 0; ci < Cin; ++ci) {
        const float wv = wp[ci * swi];
#pragma unroll
        for (int j = 0; j < PIX; ++j) {
          if (ok[j]) acc[j] = fmaf(xp[j][ci], wv, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    if (pv[j]) out[(p0 + j) * Cout + co] = acc[j];
  }
}

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
    const float* x, const float* w, float* out, int Hl, int Wl, int Cin,
    int Cout, int K, int S, int pt, int pl, int Ho, int Wo, long long sxh,
    long long sxw, long long swh, long long sww, long long swi,
    long long swo, void* stream) {
  const long long npix = (long long)Ho * Wo;
  const long long per_block = (long long)PIX_GROUPS * PIX;
  dim3 block(CO_THREADS, PIX_GROUPS);
  dim3 grid((unsigned)((npix + per_block - 1) / per_block),
            (unsigned)((Cout + CO_THREADS - 1) / CO_THREADS));
  conv_dense_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, w, out, Hl, Wl, Cin, Cout, K, S, pt, pl, Ho, Wo, sxh, sxw, swh, sww,
      swi, swo);
  return (int)cudaGetLastError();
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
