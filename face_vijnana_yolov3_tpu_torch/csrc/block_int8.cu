// One whole int8 Darknet residual block (1x1 -> 3x3 -> skip add) in one launch.
//
// Replaces face_vijnana_yolov3_tpu/ops/pallas_block.py::_block_kernel (and its
// pallas_call in fused_block_int8):
//   y1  = requant(leaky(fma(x_q @ w1, ws1, b1)), inv_s_mid)      (kept on chip)
//   out = requant(fma(x_q, skip_s, leaky(fma(conv3x3(y1, w2), ws2, b2))), inv_s_out)
// with the zero padding of the 3x3 applied to the int8 intermediate, and the
// epilogues of int8_mma.cuh (bit-exact with the JAX package's jitted
// program: same int32 sums, the same fused multiply-adds and roundings).
//
// Design. The TPU kernel flattened H*W into sublanes and shifted each tap by
// slice + concat, because Mosaic had no strided tap access. Here a block
// takes R output rows of one image and a slice of the output channels:
//   1. the 1x1 for those rows plus a one-row halo above and below, all
//      W columns, as a GEMM from device memory (cp.async, double-buffered),
//      requantized into shared memory as int8 Y[(R+2)][(W+2)][Ch + 16] with
//      zero border columns and zero rows outside the image;
//   2. the 3x3 as a GEMM whose A fragments are read straight from Y at the
//      tap's offset (no im2col, no shifted copy), B = w2 streamed through
//      shared memory.
// The 1x1 intermediate never reaches device memory, which is the point of
// the TPU kernel. Y's pixel stride Ch + 16 bytes puts the 8 pixels of a
// fragment load on distinct bank groups. The 1x1 halo rows are computed by
// both neighbouring blocks, and a block that takes a slice of the output
// channels (n_split > 1, for small batches) recomputes the whole 1x1.
//
// What bounds it on an H100: 2*H*W*(C*Ch + 9*Ch*C) int8 operations per image
// (1.772 G per block at 52^2x256/128) against 1,979 TOP/s dense, far above
// its bytes (x read once, out written once): compute-bound. This first
// version uses mma.sync and one block per SM-sized tile; wgmma/TMA later.

#include "int8_mma.cuh"

namespace {

using fvy::kBK;
using fvy::kRowStride;
using fvy::kThreads;

constexpr int kBM = 64;    // pixels per GEMM tile
constexpr int kBN = 128;   // channels per GEMM tile

struct BlockShape {
  int batch, h, w, c, ch, rows, n_split;
};

__host__ __device__ constexpr int y_stride(int ch) { return ch + 16; }

__host__ __device__ inline size_t y_bytes(int rows, int w, int ch) {
  return static_cast<size_t>(rows + 2) * (w + 2) * y_stride(ch);
}

__global__ void __launch_bounds__(kThreads)
block_int8_kernel(const signed char* __restrict__ x,
                  const signed char* __restrict__ w1,
                  const signed char* __restrict__ w2,
                  const float* __restrict__ ws1, const float* __restrict__ b1,
                  const float* __restrict__ inv_mid,
                  const float* __restrict__ ws2, const float* __restrict__ b2,
                  const float* __restrict__ skip_s,
                  const float* __restrict__ inv_out,
                  signed char* __restrict__ out, BlockShape s) {
  extern __shared__ __align__(16) signed char smem[];
  const int ps = y_stride(s.ch);
  const size_t ybytes = y_bytes(s.rows, s.w, s.ch);
  signed char* Y = smem;
  signed char* As = smem + ybytes;                      // [2][kBM * kRowStride]
  signed char* Bs = As + 2 * kBM * kRowStride;          // [2][kBN * kRowStride]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;      // 2 x 4 warps of 32x32

  const int b = blockIdx.z;
  const int r0 = blockIdx.x * s.rows;
  const int rows_out = min(s.rows, s.h - r0);
  const long long img = static_cast<long long>(b) * s.h * s.w;

  for (size_t i = static_cast<size_t>(tid) * 16; i < ybytes; i += kThreads * 16)
    *reinterpret_cast<uint4*>(Y + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  int acc[2][4][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
  };

  // ---- 1. the 1x1 over image rows [rlo, rhi): contiguous pixels of x.
  const int rlo = max(r0 - 1, 0), rhi = min(r0 + rows_out + 1, s.h);
  const int m1 = (rhi - rlo) * s.w;
  const signed char* x1 = x + (img + static_cast<long long>(rlo) * s.w) * s.c;
  const int ktiles1 = s.c / kBK;
  for (int m0 = 0; m0 < m1; m0 += kBM) {
    for (int n0 = 0; n0 < s.ch; n0 += kBN) {
      auto load_stage = [&](int stage, int kt) {
        if (tid < kBM * 2) {
          const int r = tid >> 1, half = tid & 1;
          const bool ok = m0 + r < m1;
          const signed char* src =
              ok ? x1 + static_cast<long long>(m0 + r) * s.c + kt * kBK + half * 16 : x;
          fvy::cp_async16(As + stage * kBM * kRowStride + r * kRowStride + half * 16,
                          src, ok);
        }
        {
          const int r = tid >> 1, half = tid & 1;  // 128 rows x 2 halves
          const signed char* src =
              w1 + static_cast<long long>(n0 + r) * s.c + kt * kBK + half * 16;
          fvy::cp_async16(Bs + stage * kBN * kRowStride + r * kRowStride + half * 16,
                          src, true);
        }
      };
      zero_acc();
      load_stage(0, 0);
      fvy::cp_async_commit();
      for (int kt = 0; kt < ktiles1; ++kt) {
        const int stage = kt & 1;
        if (kt + 1 < ktiles1) {
          load_stage(stage ^ 1, kt + 1);
          fvy::cp_async_commit();
          fvy::cp_async_wait<1>();
        } else {
          fvy::cp_async_wait<0>();
        }
        __syncthreads();
        const signed char* a_rows[2][2];
        const signed char* b_rows[4];
        const signed char* a_base = As + stage * kBM * kRowStride;
        const signed char* b_base = Bs + stage * kBN * kRowStride;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a_rows[mi][h] = a_base + (warp_m * 32 + mi * 16 + g + 8 * h) * kRowStride;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          b_rows[ni] = b_base + (warp_n * 32 + ni * 8 + g) * kRowStride;
        fvy::warp_tile_k32(acc, a_rows, b_rows, t);
        __syncthreads();
      }
      // requantize into Y: pixel p of rows [rlo, rhi) -> Y row p/W - (r0-1)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
          if (m >= m1) continue;
          const int r = rlo + m / s.w, col = m % s.w;
          signed char* yp = Y + (static_cast<size_t>(r - r0 + 1) * (s.w + 2) + col + 1) * ps;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = n0 + warp_n * 32 + ni * 8 + 2 * t + j;
              yp[n] = fvy::requant(acc[mi][ni][2 * h + j], ws1[n], b1[n], true,
                                   false, 0.0f, 0.0f, inv_mid[n]);
            }
        }
    }
  }
  __syncthreads();

  // ---- 2. the 3x3 from Y, channels [c_lo, c_lo + C / n_split).
  const int m2 = rows_out * s.w;
  const int c_per = s.c / s.n_split;
  const int c_lo = blockIdx.y * c_per;
  const int kc_per_tap = s.ch / kBK;
  const int ktiles2 = 9 * kc_per_tap;
  const long long kdim2 = 9LL * s.ch;
  for (int m0 = 0; m0 < m2; m0 += kBM) {
    // top-left tap of this thread's four fragment rows (dummy row 0 past m2)
    const signed char* y_rows[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
        if (m >= m2) m = 0;
        const int rr = m / s.w, cc = m % s.w;
        y_rows[mi][h] = Y + (static_cast<size_t>(rr) * (s.w + 2) + cc) * ps;
      }
    for (int n0 = c_lo; n0 < c_lo + c_per; n0 += kBN) {
      auto load_b = [&](int stage, int kt) {
        const int r = tid >> 1, half = tid & 1;
        const signed char* src =
            w2 + static_cast<long long>(n0 + r) * kdim2 + kt * kBK + half * 16;
        fvy::cp_async16(Bs + stage * kBN * kRowStride + r * kRowStride + half * 16,
                        src, true);
      };
      zero_acc();
      load_b(0, 0);
      fvy::cp_async_commit();
      for (int kt = 0; kt < ktiles2; ++kt) {
        const int stage = kt & 1;
        if (kt + 1 < ktiles2) {
          load_b(stage ^ 1, kt + 1);
          fvy::cp_async_commit();
          fvy::cp_async_wait<1>();
        } else {
          fvy::cp_async_wait<0>();
        }
        __syncthreads();
        const int tap = kt / kc_per_tap, kc = kt - tap * kc_per_tap;
        const int ky = tap / 3, kx = tap - 3 * ky;
        const size_t off = (static_cast<size_t>(ky) * (s.w + 2) + kx) * ps + kc * kBK;
        const signed char* a_rows[2][2];
        const signed char* b_rows[4];
        const signed char* b_base = Bs + stage * kBN * kRowStride;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) a_rows[mi][h] = y_rows[mi][h] + off;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          b_rows[ni] = b_base + (warp_n * 32 + ni * 8 + g) * kRowStride;
        fvy::warp_tile_k32(acc, a_rows, b_rows, t);
        __syncthreads();
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
          if (m >= m2) continue;
          const long long pix = img + static_cast<long long>(r0) * s.w + m;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = n0 + warp_n * 32 + ni * 8 + 2 * t + j;
              const long long o = pix * s.c + n;
              out[o] = fvy::requant(acc[mi][ni][2 * h + j], ws2[n], b2[n], true,
                                    true, static_cast<float>(x[o]), skip_s[n],
                                    inv_out[n]);
            }
        }
    }
  }
}

// Dynamic shared memory of one block: Y, then two stages of A and B tiles.
long long block_smem(int w, int ch, int rows) {
  return static_cast<long long>(y_bytes(rows, w, ch)) +
         2LL * (kBM + kBN) * kRowStride;
}

}  // namespace

// x, out (B, H, W, C) int8; w1 (Ch, 1, 1, C) int8; w2 (C, 3, 3, Ch) int8;
// ws1, b1, inv_mid (Ch,) and ws2, b2, skip_s, inv_out (C,) f32. C and Ch
// multiples of 128; `rows` output rows per block; `n_split` blocks share
// each row tile's output channels (C / n_split a multiple of 128). All
// contiguous on one device. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int fvy_block_int8(const signed char* x, const signed char* w1,
                              const signed char* w2, const float* ws1,
                              const float* b1, const float* inv_mid,
                              const float* ws2, const float* b2,
                              const float* skip_s, const float* inv_out,
                              signed char* out, int batch, int h, int w, int c,
                              int ch, int rows, int n_split, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || c % kBN != 0 || ch % kBN != 0 || c < kBN ||
      ch < kBN || rows < 1 || rows > h || n_split < 1 || c % n_split != 0 ||
      (c / n_split) % kBN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long smem = block_smem(w, ch, rows);
  cudaError_t e = cudaFuncSetAttribute(
      block_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  BlockShape s{batch, h, w, c, ch, rows, n_split};
  const dim3 grid(static_cast<unsigned>((h + rows - 1) / rows),
                  static_cast<unsigned>(n_split), static_cast<unsigned>(batch));
  block_int8_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      x, w1, w2, ws1, b1, inv_mid, ws2, b2, skip_s, inv_out, out, s);
  return static_cast<int>(cudaGetLastError());
}
