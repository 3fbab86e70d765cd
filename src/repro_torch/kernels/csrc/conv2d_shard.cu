// conv2d_shard for Hopper (sm_90a): one conv shard over the NT-mode local
// slice, f32 accumulation, the output in the input's type.
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
// the time (188 a pass, ~1 us each replayed).  In a 2-byte type on CUDA
// cores the many-pixel shards were bound by issuing f32 FMAs (a 784 x 64
// x 576 shard is 58 MFLOP on 0.2 MB), so those pairs take the tensor
// cores.
//
// The design: an implicit GEMM, the shared tile loop in gemm_f32.cuh.
// M = the shard's output pixels, K = (kh, kw, ci) flattened, N = the Cout
// slice.  Block tiles of BM x 64 (chosen per call by
// repro_torch/kernels/gemm.py from M and the pair's loop), with 32- or
// 64-deep slabs of the implicit im2col tile and the weight staged through
// a 3-stage cp.async ring in shared memory, and two or four groups of 128
// threads splitting each slab's depth.  x and w in one 2-byte type
// (_bf16, _f16) run the tensor-core loop (ldmatrix fragments,
// mma.sync.m16n8k16, f32 accumulators); f32 and a 2-byte x with f32
// weights run the CUDA-core loop (4x4 register tiles of f32 FMAs).  The
// graph-boundary pads are zero-fill when the A tile is filled (a cp.async
// with source size 0), the counterpart of the TPU kernel's zero-filled
// VMEM scratch: no padded copy exists in device memory.  The slab runs
// over the flattened (kh, kw, ci) index, so the Cin = 3 stems waste no
// lanes (a K of 27 or 147 ends in a zero-filled tail of its last slab).
// Where M tiles x N tiles would leave the card under-filled, the K loop
// is split into chunks whose partial tiles a second pass sums in a fixed
// order (deterministic, no atomics).  The load width is chosen per call
// from alignment: 16-byte copies along the channels (4 in f32, 8 in a
// 2-byte type) where Cin is a multiple of that and the view is aligned,
// one element a copy otherwise.
//
// Depthwise layers do 2*K*K flops per output element and are bound by
// bytes; their kernel gives each thread one (ho, wo, c) output with c
// fastest, so every tap is a coalesced load (neighbouring taps hit L1).
//
// Types: like the TPU kernel, which casts both operands to f32 and writes
// x.dtype, each entry point forms every product exactly in f32 (on the
// tensor cores for a same-type 2-byte pair, after converting each
// element to f32 otherwise), accumulates in f32 and rounds the output
// once to x's type (round to nearest even).  Entry points by (x, w) type, the output in x's: _f32
// (f32, f32), _bf16 and _f16 (both operands in the 2-byte type), _bf16_f32
// and _f16_f32 (a 2-byte x with f32 weights).  The wrapper reaches every
// other pair the TPU kernel takes by an exact upcast of the weight to f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/build.py).  Plain C
// interface; each entry point launches on the given stream and returns
// cudaGetLastError() right after the launch.

#include "gemm_f32.cuh"

namespace {

using gemm_f32::from_f32;
using gemm_f32::to_f32;

constexpr int DW_THREADS = 256;

template <typename TX, typename TW, typename TO>
__global__ void conv_dw_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, TO* __restrict__ out,
    int Hl, int Wl, int C, int K, int S, int pt, int pl, int Ho, int Wo,
    long long sxh, long long sxw, long long swh, long long sww,
    long long swc) {
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
      acc = fmaf(to_f32(x[hi * sxh + wi * sxw + c]),
                 to_f32(w[kh * swh + kw * sww + c * swc]), acc);
    }
  }
  out[idx] = from_f32<TO>(acc);
}

template <typename TX, typename TW>
int dense(const void* x, const void* w, void* out, float* ws, int Hl, int Wl,
          int Cin, int Cout, int K, int S, int pt, int pl, int Ho, int Wo,
          long long sxh, long long sxw, long long swh, long long sww,
          long long swi, long long swo, int cfg, int splits, int kchunk,
          int avec, int bvec, void* stream) {
  gemm_f32::Problem<TX, TW, TX> p;
  p.x = static_cast<const TX*>(x);
  p.w = static_cast<const TW*>(w);
  p.out = static_cast<TX*>(out);
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

template <typename TX, typename TW>
int depthwise(const void* x, const void* w, void* out, int Hl, int Wl, int C,
              int K, int S, int pt, int pl, int Ho, int Wo, long long sxh,
              long long sxw, long long swh, long long sww, long long swc,
              void* stream) {
  const long long total = (long long)Ho * Wo * C;
  dim3 grid((unsigned)((total + DW_THREADS - 1) / DW_THREADS));
  conv_dw_kernel<TX, TW, TX><<<grid, DW_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), Hl, Wl, C, K, S, pt, pl, Ho, Wo, sxh, sxw, swh,
      sww, swc);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points: conv2d_shard_dense_<suffix> and conv2d_shard_dw_<suffix>
// for x of type TX and w of type TW, the output in TX.
#define DENSE_PARAMS                                                         \
  const void *x, const void *w, void *out, float *ws, int Hl, int Wl,        \
      int Cin, int Cout, int K, int S, int pt, int pl, int Ho, int Wo,       \
      long long sxh, long long sxw, long long swh, long long sww,            \
      long long swi, long long swo, int cfg, int splits, int kchunk,         \
      int avec, int bvec, void *stream
#define DENSE_ARGS                                                           \
  x, w, out, ws, Hl, Wl, Cin, Cout, K, S, pt, pl, Ho, Wo, sxh, sxw, swh,     \
      sww, swi, swo, cfg, splits, kchunk, avec, bvec, stream
#define DW_PARAMS                                                            \
  const void *x, const void *w, void *out, int Hl, int Wl, int C, int K,     \
      int S, int pt, int pl, int Ho, int Wo, long long sxh, long long sxw,   \
      long long swh, long long sww, long long swc, void *stream
#define DW_ARGS                                                              \
  x, w, out, Hl, Wl, C, K, S, pt, pl, Ho, Wo, sxh, sxw, swh, sww, swc, stream

extern "C" int conv2d_shard_dense_f32(DENSE_PARAMS) {
  return dense<float, float>(DENSE_ARGS);
}
extern "C" int conv2d_shard_dense_bf16(DENSE_PARAMS) {
  return dense<__nv_bfloat16, __nv_bfloat16>(DENSE_ARGS);
}
extern "C" int conv2d_shard_dense_f16(DENSE_PARAMS) {
  return dense<__half, __half>(DENSE_ARGS);
}
extern "C" int conv2d_shard_dense_bf16_f32(DENSE_PARAMS) {
  return dense<__nv_bfloat16, float>(DENSE_ARGS);
}
extern "C" int conv2d_shard_dense_f16_f32(DENSE_PARAMS) {
  return dense<__half, float>(DENSE_ARGS);
}

extern "C" int conv2d_shard_dw_f32(DW_PARAMS) {
  return depthwise<float, float>(DW_ARGS);
}
extern "C" int conv2d_shard_dw_bf16(DW_PARAMS) {
  return depthwise<__nv_bfloat16, __nv_bfloat16>(DW_ARGS);
}
extern "C" int conv2d_shard_dw_f16(DW_PARAMS) {
  return depthwise<__half, __half>(DW_ARGS);
}
extern "C" int conv2d_shard_dw_bf16_f32(DW_PARAMS) {
  return depthwise<__nv_bfloat16, float>(DW_ARGS);
}
extern "C" int conv2d_shard_dw_f16_f32(DW_PARAMS) {
  return depthwise<__half, float>(DW_ARGS);
}
