// The int8 core of the int8 convolution kernels (conv_int8.cu,
// block_int8.cu): warpgroup int8 products (wgmma) and the requantizing
// epilogue, over the generic Hopper helpers of hopper.cuh.
//
// Product: wgmma.mma_async m64nNk32 s8 x s8 -> s32 (N = 32, 64 or 128),
// both operands K-major in shared memory, as 8-bit wgmma requires. Integer
// sums are exact in any order, so the accumulators equal the JAX package's
// int32 convolution (lax.conv_general_dilated with
// preferred_element_type=int32) bit for bit.
//
// Accumulator layout of m64nN (PTX ISA, wgmma register fragments): thread
// lane = 4 g + t of warp w (0..3) of the warpgroup holds d[i] at row
// 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 t + (i & 1).
// A k32 step inside a swizzled row is +32 bytes on the start address.

#pragma once

#include "hopper.cuh"

namespace fvy {

// ---- wgmma, int8

// d (64 x N, s32) += A (64 x 32, s8, descriptor a) * B (N x 32, s8, descriptor b)^T
__device__ __forceinline__ void wgmma_k32(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_k32(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


// ---- the epilogue

// The epilogue of models/quant.py::apply_graph_quant (:803-816) and of
// ops/pallas_block.py::_block_kernel (:99-101, :152-155), as XLA compiles
// them: the jitted program contracts `acc * w_scale + bias` and
// `h + skip * skip_s` into fused multiply-adds, so both are __fmaf_rn here
// (the library builds with -fmad=false: nothing else is fused, and
// `h * inv` stays a separate rounding). rintf rounds half to even, as
// jnp.round does; the clip runs before the int8 cast.
__device__ __forceinline__ signed char requant(int acc, float w_scale,
                                               float bias, bool leaky,
                                               bool has_skip, float skip,
                                               float skip_s, float inv) {
  float h = __fmaf_rn(static_cast<float>(acc), w_scale, bias);
  if (leaky) h = h > 0.0f ? h : 0.1f * h;
  if (has_skip) h = __fmaf_rn(skip, skip_s, h);
  const float r = fminf(fmaxf(rintf(h * inv), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

// The epilogue of one output tile of ROWS rows x BN int8 columns (output
// channels n0..n0+BN-1), run by NTHREADS threads (this one is `gtid` of
// them). The tile is staged in shared memory S at a row stride of BN + 16
// bytes; pix(r) gives tile row r's output pixel (out and skip hold `cout`
// channels a pixel), or -1 for a row that is dropped. The skip rows and the
// per-channel parameters are loaded into registers when the tile starts
// (their latency hides behind the tile's products), then staged in S and P.

// Per-channel parameters of a tile: NP arrays of BN floats, staged in P.
template <int BN, int NP, int NTHREADS>
struct TileParams {
  static constexpr int kN = (NP * BN + NTHREADS - 1) / NTHREADS;
  float v[kN];
  __device__ __forceinline__ void load(const float* const (&src)[NP], int n0, int cout,
                                       int gtid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = gtid + i * NTHREADS, a = idx / BN, n = n0 + idx % BN;
      const float* p = nullptr;  // src[a], selected without a runtime index
#pragma unroll
      for (int k = 0; k < NP; ++k)
        if (a == k) p = src[k];
      v[i] = p != nullptr && n < cout ? p[n] : 0.0f;
    }
  }
  __device__ __forceinline__ void store(float* P, int gtid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = gtid + i * NTHREADS;
      if (idx < NP * BN) P[idx] = v[i];
    }
  }
};

// The skip rows of a tile, 16 bytes a register quad, staged in S.
template <int BN, int ROWS, int NTHREADS>
struct TileSkip {
  static constexpr int kVecs = BN / 16, kN = ROWS * kVecs / NTHREADS;
  static_assert(ROWS * kVecs % NTHREADS == 0, "whole vectors per thread");
  uint4 v[kN];
  template <class Pix>
  __device__ __forceinline__ void load(Pix pix, const signed char* __restrict__ skip,
                                       int cout, int n0, int gtid) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = gtid + i * NTHREADS, r = idx / kVecs, n = n0 + 16 * (idx % kVecs);
      const long long p = pix(r);
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (p < 0) continue;
      const signed char* src = skip + p * cout + n;
      if (cout % 16 == 0 && n + 16 <= cout) {
        v[i] = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < cout)
            b[j >> 2] |= static_cast<uint32_t>(static_cast<unsigned char>(src[j]))
                         << (8 * (j & 3));
        v[i] = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
  }
  __device__ __forceinline__ void store(signed char* S, int gtid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = gtid + i * NTHREADS;
      *reinterpret_cast<uint4*>(S + (idx / kVecs) * (BN + 16) + 16 * (idx % kVecs)) = v[i];
    }
  }
};

// Requantizes this warpgroup's accumulators (tile rows row0..row0+63) into
// S. P holds [w_scale | bias | skip_s | inv_out] of the tile's BN channels;
// with a skip, S holds the skip rows and each value is replaced in place.
template <int BN>
__device__ __forceinline__ void requant_tile(const int (&acc)[BN / 2], int row0,
                                             signed char* S, const float* P,
                                             bool has_skip, bool leaky) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 8 * q + 2 * t + j;
      const float ws = P[c], b = P[BN + c], ss = P[2 * BN + c], inv = P[3 * BN + c];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        signed char* o = S + (row0 + 16 * w + g + 8 * h) * (BN + 16) + c;
        const float skip = has_skip ? static_cast<float>(*o) : 0.0f;
        *o = requant(acc[4 * q + 2 * h + j], ws, b, leaky, has_skip, skip, ss, inv);
      }
    }
}

// Writes the tile's rows from S to out as 16-byte rows.
template <int BN, int ROWS, int NTHREADS, class Pix>
__device__ __forceinline__ void store_tile(Pix pix, const signed char* S,
                                           signed char* __restrict__ out, int cout, int n0,
                                           int gtid) {
  constexpr int kVecs = BN / 16;
#pragma unroll
  for (int i = 0; i < ROWS * kVecs / NTHREADS; ++i) {
    const int idx = gtid + i * NTHREADS, r = idx / kVecs, n = n0 + 16 * (idx % kVecs);
    const long long p = pix(r);
    if (p < 0) continue;
    const signed char* src = S + r * (BN + 16) + (n - n0);
    signed char* d = out + p * cout + n;
    if (cout % 16 == 0 && n + 16 <= cout) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 16 && n + j < cout; ++j) d[j] = src[j];
    }
  }
}

}  // namespace fvy
