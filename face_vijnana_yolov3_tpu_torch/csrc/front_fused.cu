// The fused trunk front: conv_0 (3x3 s1, 3->32) + bias + leaky, rounded to
// bf16, then conv_1 (3x3 s2, 32->64) + bias + leaky, rounded to bf16.
//
// Replaces face_vijnana_yolov3_tpu/ops/pallas_front.py::_front_kernel (and
// its pallas_call in fused_front). Arithmetic, as there: x and both kernels
// rounded to bf16, f32 accumulation, each bias added to the f32 sum, leaky
// 0.1, one rounding to bf16 per conv; conv_0's row -1 and column -1 are
// conv_1's zero padding (exact zeros, not conv_0 evaluated off the image).
//
// Design. The TPU kernel's space-to-depth input, 16-row DMA bands and
// phantom column worked around Mosaic's tiling rules. Here one block of 8
// warps takes a tile of 8 x 16 conv_1 outputs of one image:
//   1. it reads the 19 x 35 x 3 f32 input patch (halo included, zeros off
//      the image) and rounds it to bf16 in shared memory;
//   2. conv_0 over the 17 x 33 positions the tile's conv_1 reads (561, of
//      which 512 are new: the halo costs 10 % more conv_0 work) as a GEMM
//      on mma.sync m16n8k16 bf16, M = positions, K = 27 taps x channels
//      padded to 32, N = 32; its A fragments are gathered from the patch
//      (no im2col buffer). The epilogue writes bf16 into Y[561][36] in
//      shared memory;
//   3. conv_1 as an implicit GEMM, K = 9 taps x 32 = 288: warp w computes
//      output row w (16 columns x 64 channels), A fragments read straight
//      from Y at the tap's offset, B = conv_1's weights, staged in shared
//      memory once per block;
//   4. the epilogue (+ b1, leaky, bf16) stores NHWC.
// conv_0's S^2 x 32 output never reaches device memory, which is the point
// of the TPU kernel. Y's 36-element position stride puts the 8 rows of a
// conv_1 fragment load (positions 2 apart) on distinct banks; the weight
// rows' 296-element stride does the same for B.
//
// What bounds it on an H100: per image 2*S^2*27*32 + 2*(S/2)^2*288*64
// operations (1.89 G at 416^2) against 989 TFLOP/s of bf16, and 12*S^2 bytes
// of f32 in plus 2*(S/2)^2*64 of bf16 out (7.6 MB at 416^2) against 3.35
// TB/s: bytes bound it (0.073 ms at b=32). This first version reads its
// fragments with 32-bit shared-memory loads, about 2.5 per mma, so shared
// memory, not the tensor cores or device memory, limits it; wgmma, TMA and
// a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 8, kTC = 16;                    // conv_1 outputs per block
constexpr int kYR = 2 * kTR + 1, kYC = 2 * kTC + 1;  // conv_0 tile, halo incl.
constexpr int kNY = kYR * kYC;                       // 561 positions
constexpr int kMT0 = (kNY + 15) / 16;                // conv_0 m16 tiles: 36
constexpr int kXR = 2 * kTR + 3, kXC = 2 * kTC + 3;  // input patch 19 x 35
constexpr int kXN = kXR * kXC * 3;
constexpr int kC0 = 32, kC1 = 64;
constexpr int kK0 = 32;                              // conv_0 K, 27 padded
constexpr int kK1 = 9 * kC0;                         // conv_1 K = 288
constexpr int kYS = 36;                              // Y position stride
constexpr int kWS = kK1 + 8;                         // conv_1 weight row stride
constexpr float kLeaky = 0.1f;

constexpr int kXBytes = (kXN * 2 + 15) / 16 * 16;
constexpr int kYBytes = (kNY * kYS * 2 + 15) / 16 * 16;
constexpr int kWBytes = kC1 * kWS * 2;
constexpr int kSmem = kXBytes + kYBytes + kWBytes;   // 82,288 bytes

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Two f32 values -> one 32-bit word of bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(bf16_bits(lo)) |
         (static_cast<uint32_t>(bf16_bits(hi)) << 16);
}

__device__ __forceinline__ float leaky(float v) { return v > 0.0f ? v : kLeaky * v; }

// Offset of conv_0's K index k = (dy * 3 + dx) * 3 + cin inside the input
// patch, relative to the patch position of the tap (0, 0); -1 for the zero
// padding of K from 27 to 32.
__device__ __forceinline__ int patch_offset(int k) {
  if (k >= 27) return -1;
  return ((k / 9) * kXC + (k / 3) % 3) * 3 + k % 3;
}

__global__ void __launch_bounds__(kThreads)
front_fused_kernel(const float* __restrict__ x, const uint16_t* __restrict__ w0,
                   const float* __restrict__ b0, const uint16_t* __restrict__ w1,
                   const float* __restrict__ b1, uint16_t* __restrict__ out,
                   int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ys = reinterpret_cast<uint16_t*>(smem + kXBytes);
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem + kXBytes + kYBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int gs = s / 2;
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * kTR, q0 = blockIdx.x * kTC;

  // ---- 0. conv_1's weights into shared memory, 16 bytes a copy.
  for (int i = tid; i < kC1 * (kK1 / 8); i += kThreads) {
    const int r = i / (kK1 / 8), c = i % (kK1 / 8);
    *reinterpret_cast<uint4*>(ws + r * kWS + c * 8) =
        *reinterpret_cast<const uint4*>(w1 + r * kK1 + c * 8);
  }
  // ---- 1. the input patch, rows 2*p0-2.., columns 2*q0-2.., as bf16.
  const long long img = static_cast<long long>(b) * s * s;
  for (int i = tid; i < kXN; i += kThreads) {
    const int u = i / (kXC * 3), rem = i % (kXC * 3);
    const int v = rem / 3, ci = rem % 3;
    const int xr = 2 * p0 - 2 + u, xc = 2 * q0 - 2 + v;
    float val = 0.0f;
    if (xr >= 0 && xr < s && xc >= 0 && xc < s)
      val = x[((img + static_cast<long long>(xr) * s) + xc) * 3 + ci];
    xs[i] = bf16_bits(val);
  }
  __syncthreads();

  // ---- 2. conv_0 over the tile's 561 positions into Y.
  {
    // This thread's K indices in the m16n8k16 A fragment (PTX ISA): step ks
    // covers K 16*ks.., registers 0/1 hold columns 2t, 2t+1 and 2/3 hold
    // 2t+8, 2t+9 (rows g and g+8).
    int koff[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        koff[ks][j] = patch_offset(16 * ks + 2 * t + (j & 1) + 8 * (j >> 1));
    // B fragments: w0 row (output channel) nt*8 + g, K 16*ks + 2t.. and +8..
    uint32_t bw[4][2][2];
    float bias0[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint16_t* row = w0 + (nt * 8 + g) * kK0;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        bw[nt][ks][0] = ld32(row + 16 * ks + 2 * t);
        bw[nt][ks][1] = ld32(row + 16 * ks + 2 * t + 8);
      }
      bias0[nt][0] = b0[nt * 8 + 2 * t];
      bias0[nt][1] = b0[nt * 8 + 2 * t + 1];
    }
    for (int mt = warp; mt < kMT0; mt += kThreads / 32) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(mt * 16 + g + 8 * h, kNY - 1);  // pad rows: any valid
        base[h] = ((m / kYC) * kXC + m % kYC) * 3;
      }
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // register r: row g + 8*(r & 1), columns pair r >> 1
          const int h = r & 1, pair = r >> 1;
          const int k_lo = koff[ks][2 * pair], k_hi = koff[ks][2 * pair + 1];
          const uint32_t lo = k_lo < 0 ? 0u : xs[base[h] + k_lo];
          const uint32_t hi = k_hi < 0 ? 0u : xs[base[h] + k_hi];
          a[ks][r] = lo | (hi << 16);
        }
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) mma_bf16(acc[nt], a[ks], bw[nt][ks][0], bw[nt][ks][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        if (m >= kNY) continue;
        const int yi = m / kYC, yj = m % kYC;
        // conv_1's zero padding: conv_0 row -1 / column -1.
        const bool pad = (p0 == 0 && yi == 0) || (q0 == 0 && yj == 0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float v0 = pad ? 0.0f : leaky(acc[nt][2 * h] + bias0[nt][0]);
          const float v1 = pad ? 0.0f : leaky(acc[nt][2 * h + 1] + bias0[nt][1]);
          *reinterpret_cast<uint32_t*>(ys + m * kYS + nt * 8 + 2 * t) = pack_bf16(v0, v1);
        }
      }
    }
  }
  __syncthreads();

  // ---- 3. conv_1: warp w -> output row p0 + w, columns q0..q0+15 (M = 16).
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
  // Y position of output column q at tap (0, 0): row 2w, column 2q.
  const uint16_t* yrow[2] = {ys + (2 * warp * kYC + 2 * g) * kYS,
                             ys + (2 * warp * kYC + 2 * (g + 8)) * kYS};
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const int yoff = (dy * kYC + dx) * kYS;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kc = half * 16 + 2 * t;
      uint32_t a[4];
      a[0] = ld32(yrow[0] + yoff + kc);
      a[1] = ld32(yrow[1] + yoff + kc);
      a[2] = ld32(yrow[0] + yoff + kc + 8);
      a[3] = ld32(yrow[1] + yoff + kc + 8);
      const int kw = tap * kC0 + kc;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* wr = ws + (nt * 8 + g) * kWS + kw;
        mma_bf16(acc[nt], a, ld32(wr), ld32(wr + 8));
      }
    }
  }

  // ---- 4. epilogue: + b1, leaky, bf16, NHWC.
  const int p = p0 + warp;
  if (p >= gs) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + g + 8 * h;
    if (q >= gs) continue;
    uint16_t* o = out + ((static_cast<long long>(b) * gs + p) * gs + q) * kC1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int co = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(o + co) =
          pack_bf16(leaky(acc[nt][2 * h] + b1[co]), leaky(acc[nt][2 * h + 1] + b1[co + 1]));
    }
  }
}

}  // namespace

// x (B, S, S, 3) f32 NHWC, S even; w0 (32, 32) bf16 [cout][(dy*3+dx)*3+cin],
// K padded with zeros from 27; b0 (32,) f32; w1 (64, 288) bf16
// [cout][(dy*3+dx)*32+cin]; b1 (64,) f32; out (B, S/2, S/2, 64) bf16. All
// contiguous on one device, 16-byte aligned. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int fvy_front_fused(const float* x, const uint16_t* w0, const float* b0,
                               const uint16_t* w1, const float* b1, uint16_t* out,
                               int batch, int s, void* stream) {
  if (batch < 0 || batch > 65535 || s < 2 || s % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      front_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int gs = s / 2;
  const dim3 grid(static_cast<unsigned>((gs + kTC - 1) / kTC),
                  static_cast<unsigned>((gs + kTR - 1) / kTR),
                  static_cast<unsigned>(batch));
  front_fused_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      x, w0, b0, w1, b1, out, s);
  return static_cast<int>(cudaGetLastError());
}
