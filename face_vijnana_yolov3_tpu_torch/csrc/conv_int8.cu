// int8 convolution with its requantizing epilogue fused, as an implicit GEMM
// on the int8 tensor cores.
//
// Replaces what XLA lowers on the TPU for models/quant.py::_conv_int8
// (:666-675) plus the epilogue in apply_graph_quant (:803-816): a k in {1, 3},
// stride in {1, 2}, pad k/2 convolution of NHWC int8 activations with int8
// weights, int32 accumulation, then
//   h = fma(acc, w_scale, bias) -> leaky 0.1 -> [h = fma(skip, skip_s, h)]
//   -> rint(h * inv_out) -> clip +-127 -> int8 NHWC.
// The JAX package has no Pallas kernel for it; PyTorch has no int8
// convolution on CUDA, so the port needs this one.
//
// GEMM view: M = B*Ho*Wo output pixels, N = Cout, K = k*k*Cin in the weight
// order (ky, kx, ci) (weights stored [Cout][K], i.e. OHWI). A block computes a
// 128x64 output tile with 8 warps (4 along M x 2 along N, each 32x32), in
// 32-byte K steps double-buffered through shared memory with cp.async; the
// padding of the convolution is cp.async's zero fill. With Cin a multiple of
// 32 a 16-byte A chunk never straddles a tap; conv_0 (Cin = 3, K = 27) takes
// the byte-wise loader, which also zero-fills the ragged end of K.
//
// What bounds it on an H100: at the trunk's shapes the work is
// 2*M*N*K int8 operations against 1,979 TOP/s dense (about 13.6 G per 416^2
// image for the convs this kernel runs with the residual-block kernel on), far
// above the bytes (an activation read and one written per conv, 3.35 TB/s):
// compute-bound. This first version uses mma.sync (about half the card's
// int8 rate; wgmma and TMA reach the rest) and two pipeline stages.

#include "int8_mma.cuh"

namespace {

using fvy::kBK;
using fvy::kRowStride;
using fvy::kThreads;

constexpr int kBM = 128;
constexpr int kBN = 64;

struct ConvShape {
  int batch, h, w, cin, ho, wo, cout, k, stride, pad, kdim;
  long long m;  // batch * ho * wo
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const signed char* __restrict__ x,
                 const signed char* __restrict__ wq,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ bias,
                 const signed char* __restrict__ skip,
                 const float* __restrict__ skip_s,
                 const float* __restrict__ inv_out,
                 signed char* __restrict__ out, ConvShape s, int leaky) {
  __shared__ __align__(16) signed char As[2][kBM * kRowStride];
  __shared__ __align__(16) signed char Bs[2][kBN * kRowStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // This thread's A row (one 16-byte half of it) for every K step.
  const int a_row = tid >> 1, a_half = tid & 1;
  const long long am = m0 + a_row;
  const bool a_in = am < s.m;
  int a_b = 0, a_ho = 0, a_wo = 0;
  if (a_in) {
    a_wo = static_cast<int>(am % s.wo);
    const long long r = am / s.wo;
    a_ho = static_cast<int>(r % s.ho);
    a_b = static_cast<int>(r / s.ho);
  }
  // This thread's B row (threads 0..127).
  const int b_row = tid >> 1, b_half = tid & 1;
  const int bn = n0 + b_row;

  const int ktiles = (s.kdim + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    signed char* a_dst = &As[stage][a_row * kRowStride + a_half * 16];
    if (kVec) {
      const int kk = kt * kBK + a_half * 16;
      const int tap = kk / s.cin, ci = kk - tap * s.cin;
      const int ky = tap / s.k, kx = tap - ky * s.k;
      const int hi = a_ho * s.stride - s.pad + ky;
      const int wi = a_wo * s.stride - s.pad + kx;
      const bool ok = a_in && hi >= 0 && hi < s.h && wi >= 0 && wi < s.w;
      const signed char* src =
          ok ? x + ((static_cast<long long>(a_b) * s.h + hi) * s.w + wi) * s.cin + ci
             : x;
      fvy::cp_async16(a_dst, src, ok);
    } else {
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; j < 16; ++j) {
        const int kk = kt * kBK + a_half * 16 + j;
        if (!a_in || kk >= s.kdim) continue;
        const int tap = kk / s.cin, ci = kk - tap * s.cin;
        const int ky = tap / s.k, kx = tap - ky * s.k;
        const int hi = a_ho * s.stride - s.pad + ky;
        const int wi = a_wo * s.stride - s.pad + kx;
        if (hi < 0 || hi >= s.h || wi < 0 || wi >= s.w) continue;
        const uint32_t v = static_cast<unsigned char>(
            x[((static_cast<long long>(a_b) * s.h + hi) * s.w + wi) * s.cin + ci]);
        words[j >> 2] |= v << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(a_dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
    if (tid < kBN * 2) {
      signed char* b_dst = &Bs[stage][b_row * kRowStride + b_half * 16];
      const int kk = kt * kBK + b_half * 16;
      if (kVec) {
        const bool ok = bn < s.cout;
        const signed char* src =
            ok ? wq + static_cast<long long>(bn) * s.kdim + kk : wq;
        fvy::cp_async16(b_dst, src, ok);
      } else {
        uint32_t words[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < 16; ++j) {
          if (bn >= s.cout || kk + j >= s.kdim) continue;
          const uint32_t v = static_cast<unsigned char>(
              wq[static_cast<long long>(bn) * s.kdim + kk + j]);
          words[j >> 2] |= v << (8 * (j & 3));
        }
        *reinterpret_cast<uint4*>(b_dst) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  load_stage(0, 0);
  fvy::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ktiles) {
      load_stage(stage ^ 1, kt + 1);
      fvy::cp_async_commit();
      fvy::cp_async_wait<1>();
    } else {
      fvy::cp_async_wait<0>();
    }
    __syncthreads();
    const signed char* a_rows[2][2];
    const signed char* b_rows[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a_rows[mi][h] =
            &As[stage][(warp_m * 32 + mi * 16 + g + 8 * h) * kRowStride];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      b_rows[ni] = &Bs[stage][(warp_n * 32 + ni * 8 + g) * kRowStride];
    fvy::warp_tile_k32(acc, a_rows, b_rows, t);
    __syncthreads();
  }

  // Epilogue: c0/c1 are row g, columns 2t and 2t+1; c2/c3 row g + 8.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
      if (m >= s.m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + warp_n * 32 + ni * 8 + 2 * t + j;
          if (n >= s.cout) continue;
          const long long o = m * s.cout + n;
          out[o] = fvy::requant(acc[mi][ni][2 * h + j], w_scale[n], bias[n],
                                leaky != 0, skip != nullptr,
                                skip != nullptr ? static_cast<float>(skip[o]) : 0.0f,
                                skip != nullptr ? skip_s[n] : 0.0f, inv_out[n]);
        }
    }
}

}  // namespace

// x (B, H, W, Cin) int8; wq (Cout, k, k, Cin) int8; w_scale, bias, inv_out
// (Cout,) f32; skip (B, Ho, Wo, Cout) int8 and skip_s (Cout,) f32, or both
// null; out (B, Ho, Wo, Cout) int8. All contiguous on one device. Launches
// on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fvy_conv_int8(const signed char* x, const signed char* wq,
                             const float* w_scale, const float* bias,
                             const signed char* skip, const float* skip_s,
                             const float* inv_out, signed char* out, int batch,
                             int h, int w, int cin, int cout, int k, int stride,
                             int leaky, void* stream) {
  if ((k != 1 && k != 3) || (stride != 1 && stride != 2) || batch < 0 ||
      h < 1 || w < 1 || cin < 1 || cout < 1 || ((skip == nullptr) != (skip_s == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvShape s;
  s.batch = batch;
  s.h = h;
  s.w = w;
  s.cin = cin;
  s.cout = cout;
  s.k = k;
  s.stride = stride;
  s.pad = k / 2;
  s.ho = (h + 2 * s.pad - k) / stride + 1;
  s.wo = (w + 2 * s.pad - k) / stride + 1;
  s.kdim = k * k * cin;
  s.m = static_cast<long long>(batch) * s.ho * s.wo;
  if (s.m == 0) return 0;
  const dim3 grid(static_cast<unsigned>((s.m + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cin % kBK == 0)
    conv_int8_kernel<true><<<grid, kThreads, 0, st>>>(
        x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky);
  else
    conv_int8_kernel<false><<<grid, kThreads, 0, st>>>(
        x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky);
  return static_cast<int>(cudaGetLastError());
}
