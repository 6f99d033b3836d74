// Shared pieces of the int8 convolution kernels (conv_int8.cu, block_int8.cu):
// the int8 tensor-core product, cp.async copies, the warp's 32x32 tile step
// and the requantizing epilogue.
//
// Product: mma.sync m16n8k32 s8 x s8 -> s32. Integer sums are exact in any
// order, so the accumulators equal the JAX package's int32 convolution
// (lax.conv_general_dilated with preferred_element_type=int32) bit for bit.
//
// Operand layout in shared memory: every tile row holds 32 bytes of K (one
// mma step) at a stride of kRowStride = 48 bytes. The 16 bytes of padding
// put the 8 rows a fragment load touches on 8 distinct groups of 4 banks.
// A rows are output pixels, B rows are output channels (weights stored
// [Cout][K], K contiguous: the "col" operand of the mma).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fvy {

constexpr int kThreads = 256;    // 8 warps per block, each a 32x32 output tile
constexpr int kBK = 32;          // K bytes per mma step
constexpr int kRowStride = 48;   // shared-memory bytes per tile row

__device__ __forceinline__ uint32_t ld32(const signed char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte global -> shared copy; `valid` false writes 16 zero bytes (the
// source is not read, and `src` must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 32-byte K step of a warp's 32x32 tile: 2 (m16) x 4 (n8) mma tiles.
// a_rows[mi][h] points at this K step's first byte of tile row
// mi*16 + g + 8*h (g = lane / 4), b_rows[ni] at that of B row ni*8 + g.
// Fragment layout of m16n8k32 (PTX ISA): a0/a1 hold rows g/g+8 at K bytes
// 4t..4t+3 (t = lane % 4), a2/a3 the same rows at 16+4t..; b0/b1 hold B row
// g at K bytes 4t.. and 16+4t...
__device__ __forceinline__ void warp_tile_k32(int (&acc)[2][4][4],
                                              const signed char* const (&a_rows)[2][2],
                                              const signed char* const (&b_rows)[4],
                                              int t) {
  uint32_t a[2][4];
  uint32_t b[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    a[mi][0] = ld32(a_rows[mi][0] + 4 * t);
    a[mi][1] = ld32(a_rows[mi][1] + 4 * t);
    a[mi][2] = ld32(a_rows[mi][0] + 16 + 4 * t);
    a[mi][3] = ld32(a_rows[mi][1] + 16 + 4 * t);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    b[ni][0] = ld32(b_rows[ni] + 4 * t);
    b[ni][1] = ld32(b_rows[ni] + 16 + 4 * t);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
}

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

}  // namespace fvy
