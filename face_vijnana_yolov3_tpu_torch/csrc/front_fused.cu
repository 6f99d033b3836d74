// The fused trunk front: conv_0 (3x3 s1, 3->32) + bias + leaky, rounded to
// bf16, then conv_1 (3x3 s2, 32->64) + bias + leaky, rounded to bf16.
//
// Replaces face_vijnana_yolov3_tpu/ops/pallas_front.py::_front_kernel (and
// its pallas_call in fused_front). Arithmetic, as there: x and both kernels
// rounded to bf16, f32 accumulation, each bias added to the f32 sum, leaky
// 0.1, one rounding to bf16 per conv; conv_0's row -1 and column -1 are
// conv_1's zero padding (exact zeros, not conv_0 evaluated off the image).
//
// What bounds it on an H100: per image 2*S^2*27*32 + 2*(S/2)^2*288*64
// operations (1.89 G at 416^2) against 989 TFLOP/s of bf16, and 12*S^2 bytes
// of f32 in plus 2*(S/2)^2*64 of bf16 out (7.6 MB at 416^2) against 3.35
// TB/s: bytes bound it (0.073 ms at b=32), the operations close behind
// (0.061 ms). So the copies and the tensor cores have to overlap, and no
// byte may be moved twice. In practice the CUDA-core work around the
// products (bias, leaky, rounding and packing of conv_0's 18 k values a
// tile) is the largest part, and it is what the schedule overlaps.
//
// Design. A tile is 8 x 16 conv_1 outputs of one image. The blocks are
// persistent (two per SM) and walk tiles blockIdx.x, + gridDim.x, ...:
//   0. once per block, both convs' weights go to shared memory in the layout
//      wgmma reads (no-swizzle K-major: 16-byte rows of 8 K values, one
//      plane of rows per 8 K), and both biases beside them;
//   1. thread 0 loads each tile's f32 input patch (19 rows from 2*p0-2;
//      pixels from column 2*q0-2) one tile ahead, with one TMA box of a 3-D
//      tensor map over x as (B, S, S*3): 19 rows of 116 floats from float
//      column 6*q0-12 (a box must start on a 16-byte multiple, which 6*q0-6
//      is not), into a ring of two slots guarded by full/empty mbarriers, so
//      the next tile's input arrives while this one computes (no producer
//      warp: 256 threads leave two blocks an SM 128 registers a thread); TMA's
//      out-of-bounds fill gives the zeros off the image, negative start
//      coordinates included. TMA needs a row pitch (12*S bytes) that is a
//      multiple of 16, so where S % 4 == 2 the consumers load the patch
//      themselves from device memory (the same kernel, the same layout after
//      this step);
//   2. each of the two consumer warpgroups then runs the tile's rows that
//      it owns on its own, with 128-thread barriers only: warpgroup wg
//      computes conv_1 output rows 4 wg .. 4 wg + 3, which read conv_0 rows
//      8 wg .. 8 wg + 8 (row 8 is computed by both), which read patch rows
//      8 wg .. 8 wg + 10. It rounds those patch rows to bf16 once, as
//      4-channel pixels (8 bytes, the 4th channel 0), so that conv_0's A
//      row for position (r, j) and kernel row dy, pixels (r + dy, j .. j +
//      3), is 32 contiguous bytes: K = 3 kernel rows x 16 (3 pixels x 4
//      channels, padded with a 4th pixel) against conv_0's weights with
//      zeros at the padded slots; each A register is one aligned 32-bit
//      shared load, with no per-element table (ldmatrix would need 16-byte
//      aligned rows; a pixel is 8 bytes). A pad slot multiplies a finite
//      input by 0 and adds an exact 0 (a non-finite input pixel would
//      spread to the position two columns left as NaN);
//   3. conv_0 over the warpgroup's 9 x 33 positions in 5 chunks of 64 on
//      wgmma.mma_async m64n32k16 (A from registers, B by descriptor), two
//      accumulator sets in flight: chunk c + 1's products run on the tensor
//      cores while the warpgroup rounds chunk c into Y. Y, split by column
//      parity: Y[row][parity][8-channel group][u][8], u = column / 2, 16
//      bytes a (position, group); each warpgroup has its own 9 rows;
//   4. conv_1 on wgmma.mma_async m64n64k16 (f32 accumulators), warp w of
//      the warpgroup one output row of 16; A from registers: for tap (dy,
//      dx) the 16 outputs read Y at column 2 q + dx, which in parity plane
//      dx & 1 are 16 consecutive 16-byte rows, so one ldmatrix.x4 per k16
//      step gives the fragment without a bank conflict. The 18 k16 steps
//      are unrolled (six groups of three, a group's fragments loaded and
//      issued while the one before it runs), as are conv_0's, so ptxas does
//      not serialise the wgmma;
//   5. the epilogue (+ b1, leaky, bf16) stages the warpgroup's 64 x 64
//      outputs in its own Y rows, then writes them as 16-byte stores: a tile
//      row is 2,048 contiguous bytes of the NHWC output. The stores drain
//      while the next tile starts.
// With two blocks an SM, four warpgroups at different phases share its
// tensor cores and CUDA cores. conv_0's S^2 x 32 output never reaches
// device memory, which is the point of the TPU kernel.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace fvy;

constexpr int kThreads = 256;                        // two warpgroups
constexpr int kTR = 8, kTC = 16;                     // conv_1 outputs a tile
constexpr int kYC = 2 * kTC + 1;                     // conv_0 columns: 33
constexpr int kYRw = kTR + 1;                        // conv_0 rows a warpgroup: 9
constexpr int kNYw = kYRw * kYC;                     // 297 positions a warpgroup
constexpr int kChunks = (kNYw + 63) / 64;            // conv_0 m64 chunks: 5
constexpr int kXR = 2 * kTR + 3, kXC = 2 * kTC + 4;  // input patch 19 x 36 pixels
constexpr int kXRw = kYRw + 2;                       // patch rows a warpgroup: 11
// The TMA box row: 38 pixels from column 2 q0 - 4, 116 floats, so patch
// pixel c sits at float 3 c + 6 of its row.
constexpr int kXF = 116;
constexpr int kXF0 = 6;
constexpr int kU = kTC + 1;                          // positions a parity plane
constexpr int kC0 = 32, kC1 = 64;
constexpr int kK0 = 48;                              // conv_0 K: 3 x (4 px x 4 ch)
constexpr int kK1 = 9 * kC0;                         // conv_1 K = 288
constexpr int kOS = 2 * kC1 + 16;                    // staged output row, bytes
constexpr float kLeaky = 0.1f;

// Shared memory, from a 1024-byte aligned base.
constexpr int kSlot = (kXR * kXF * 4 + 127) / 128 * 128;  // 8,832 (8,816 used)
constexpr int kOffW1 = 2 * kSlot;                         // ring: two slots
constexpr int kOffW0 = kOffW1 + kK1 * kC1 * 2;            // + 36,864
constexpr int kOffY = kOffW0 + kK0 * kC0 * 2;             // + 3,072
constexpr int kYRowBytes = 2 * 4 * kU * 16;               // 2,176 a Y row
constexpr int kYwBytes = kYRw * kYRowBytes;               // 19,584 a warpgroup
constexpr int kOffXb = kOffY + 2 * kYwBytes;              // + 39,168
constexpr int kXbwBytes = kXRw * kXC * 8;                 // 3,168 a warpgroup
constexpr int kOffB0 = kOffXb + 2 * kXbwBytes;            // + 6,336
constexpr int kOffB1 = kOffB0 + kC0 * 4;
constexpr int kOffBar = kOffB1 + kC1 * 4;
constexpr int kSmem = kOffBar + 4 * 8 + 1024;             // + alignment slack
// The staged outputs of a warpgroup take the first rows of its own Y.
static_assert(64 * kOS <= kYwBytes, "staging fits the warpgroup's Y");

__device__ __forceinline__ uint32_t ld_shared32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 values -> one word of bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// where(v > 0, v, 0.1 v) for every v, NaN and -0 included: 0.1 v < v exactly
// when v > 0.
__device__ __forceinline__ float leaky(float v) { return fmaxf(v, kLeaky * v); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d (64 x 32, f32) (+)= A (64 x 16 bf16, registers) * B (32 x 16 bf16,
// descriptor b)^T; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_n32k16(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers) * B (64 x 16 bf16, descriptor b)^T
__device__ __forceinline__ void wgmma_n64k16(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

struct FrontShape {
  int s, gs, tiles_w, tiles_h, tiles, use_tma;
};

// conv_0's A fragment of one chunk and kernel row dy, per thread: rows g and
// g + 8 of the warp's 16 (positions of the warpgroup's 9 x 33), K 16 dy +
// 2 t4 .. (registers 0/1) and + 8 .. (2/3).
__device__ __forceinline__ void conv0_a(uint32_t (&a)[3][4], const unsigned char* xb,
                                        int chunk, int wq, int g, int t4) {
  const unsigned char* row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = min(64 * chunk + 16 * wq + g + 8 * h, kNYw - 1);  // pad rows: any valid
    const int r = m / kYC, j = m - r * kYC;
    row[h] = xb + (r * kXC + j) * 8 + 4 * t4;
  }
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    a[dy][0] = ld_shared32(row[0] + dy * kXC * 8);
    a[dy][1] = ld_shared32(row[1] + dy * kXC * 8);
    a[dy][2] = ld_shared32(row[0] + dy * kXC * 8 + 16);
    a[dy][3] = ld_shared32(row[1] + dy * kXC * 8 + 16);
  }
}

// conv_0's epilogue of one chunk: + b0, leaky, bf16 into the warpgroup's Y;
// conv_0 row -1 / column -1 (conv_1's zero padding) are written as 0.
__device__ __forceinline__ void conv0_store(const float (&acc)[16], unsigned char* ys,
                                            const float (&bias)[4][2], int chunk, int wq,
                                            int g, int t4, bool top, bool left) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 64 * chunk + 16 * wq + g + 8 * h;
    if (m >= kNYw) continue;
    const int r = m / kYC, j = m - r * kYC;
    const bool pad = (top && r == 0) || (left && j == 0);
    unsigned char* y = ys + r * kYRowBytes + ((j & 1) * 4 * kU + (j >> 1)) * 16 + 4 * t4;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t v = pack_bf16(leaky(acc[4 * nt + 2 * h] + bias[nt][0]),
                                   leaky(acc[4 * nt + 2 * h + 1] + bias[nt][1]));
      *reinterpret_cast<uint32_t*>(y + nt * kU * 16) = pad ? 0u : v;
    }
  }
}

__device__ __forceinline__ void conv0_issue(float (&acc)[16], const uint32_t (&a)[3][4],
                                            uint32_t w0base) {
  wgmma_fence();
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
    wgmma_n32k16(acc, a[dy], smem_desc(w0base + dy * 1024, 512, 128, kInterleave), dy);
  wgmma_commit();
}

// Thread 0 loads tile `it` (its `t`) into ring slot it % 2, once both
// warpgroups have released that slot's previous tile.
__device__ __forceinline__ void load_patch(const CUtensorMap* xmap, unsigned char* slot,
                                           uint64_t* full, uint64_t* empty, int it,
                                           int b, int p0, int q0) {
  mbar_wait(empty, ((it >> 1) & 1) ^ 1);
  mbar_expect_tx(full, kXR * kXF * 4);
  tma_load_3d(slot, xmap, 6 * q0 - 12, 2 * p0 - 2, b, full);
}

__global__ void __launch_bounds__(kThreads, 2)
front_fused_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ x,
                   const uint16_t* __restrict__ w0, const float* __restrict__ b0,
                   const uint16_t* __restrict__ w1, const float* __restrict__ b1,
                   uint16_t* __restrict__ out, FrontShape sh) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* b0s = reinterpret_cast<float*>(smem + kOffB0);
  float* b1s = reinterpret_cast<float*>(smem + kOffB1);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + 2;
  const int tid = threadIdx.x;

  // ---- 0. the weights, once per block: element (n, k) of a [N][K] matrix
  // at (k / 8) * 16 N + 16 n + 2 (k % 8) (W1s: N = 64, W0s: N = 32).
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  for (int i = tid; i < kC1 * (kK1 / 8); i += kThreads) {
    const int n = i / (kK1 / 8), kg = i - n * (kK1 / 8);
    *reinterpret_cast<uint4*>(smem + kOffW1 + kg * 16 * kC1 + n * 16) =
        *reinterpret_cast<const uint4*>(w1 + n * kK1 + kg * 8);
  }
  for (int i = tid; i < kC0 * (kK0 / 8); i += kThreads) {
    const int n = i / (kK0 / 8), kg = i - n * (kK0 / 8);
    *reinterpret_cast<uint4*>(smem + kOffW0 + kg * 16 * kC0 + n * 16) =
        *reinterpret_cast<const uint4*>(w0 + n * kK0 + kg * 8);
  }
  if (tid < kC0) b0s[tid] = b0[tid];
  if (tid < kC1) b1s[tid] = b1[tid];
  fence_proxy_async();  // the weights are read by wgmma (the async proxy)
  __syncthreads();

  auto decode = [&](int t, int& b, int& p0, int& q0) {
    const int tx = t % sh.tiles_w;
    t /= sh.tiles_w;
    p0 = (t % sh.tiles_h) * kTR;
    q0 = tx * kTC;
    b = t / sh.tiles_h;
  };

  if (sh.use_tma && tid == 0 && static_cast<int>(blockIdx.x) < sh.tiles) {
    int b, p0, q0;
    decode(blockIdx.x, b, p0, q0);
    load_patch(&xmap, smem, &full[0], &empty[0], 0, b, p0, q0);
  }
  const int lane = tid & 31, wtid = tid & 127;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = tid >> 7, wq = (tid >> 5) & 3;
  const int bar = 1 + wg;  // this warpgroup's named barrier
  unsigned char* Ys = smem + kOffY + wg * kYwBytes;
  unsigned char* Xb = smem + kOffXb + wg * kXbwBytes;
  const uint32_t w0base = smem_u32(smem + kOffW0), w1base = smem_u32(smem + kOffW1);
  float bias0[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bias0[nt][0] = b0s[nt * 8 + 2 * t4];
    bias0[nt][1] = b0s[nt * 8 + 2 * t4 + 1];
  }
  int it = 0;
  for (int t = blockIdx.x; t < sh.tiles; t += gridDim.x, ++it) {
    int b, p0, q0;
    decode(t, b, p0, q0);
    const int st = it & 1;

    // ---- 1-2. this warpgroup's 11 patch rows (8 wg ..) as bf16 4-channel
    // pixels: Xb[a][c], a < 11, c < 36.
    if (sh.use_tma) mbar_wait(&full[st], (it >> 1) & 1);
    const float* ring = reinterpret_cast<const float*>(smem + st * kSlot) + 8 * wg * kXF;
    for (int i = wtid; i < kXRw * kXC; i += 128) {
      const int a = i / kXC, c = i - a * kXC;
      float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
      if (sh.use_tma) {
        const float* src = ring + a * kXF + kXF0 + 3 * c;
        v0 = src[0];
        v1 = src[1];
        v2 = src[2];
      } else {
        const int xr = 2 * p0 - 2 + 8 * wg + a, xc = 2 * q0 - 2 + c;
        if (xr >= 0 && xr < sh.s && xc >= 0 && xc < sh.s) {
          const float* src = x + ((static_cast<long long>(b) * sh.s + xr) * sh.s + xc) * 3;
          v0 = src[0];
          v1 = src[1];
          v2 = src[2];
        }
      }
      *reinterpret_cast<uint2*>(Xb + i * 8) = make_uint2(pack_bf16(v0, v1), pack_bf16(v2, 0.0f));
    }
    // Xb is complete, this warpgroup is done with the ring slot, and its
    // previous tile's staged outputs (in Y) have left.
    bar_sync(bar, 128);
    if (sh.use_tma && wtid == 0) mbar_arrive(&empty[st]);
    // The next tile's patch, a whole tile ahead (its slot was released when
    // both warpgroups converted the tile before this one).
    if (sh.use_tma && tid == 0 && t + static_cast<int>(gridDim.x) < sh.tiles) {
      int nb, np0, nq0;
      decode(t + gridDim.x, nb, np0, nq0);
      load_patch(&xmap, smem + (st ^ 1) * kSlot, &full[st ^ 1], &empty[st ^ 1], it + 1,
                 nb, np0, nq0);
    }

    // ---- 3. conv_0: chunk c + 1's products run while chunk c is rounded.
    {
      const bool top = p0 == 0 && wg == 0, left = q0 == 0;
      float acc[2][16];
      uint32_t a[2][3][4];
      conv0_a(a[0], Xb, 0, wq, g, t4);
      conv0_issue(acc[0], a[0], w0base);
#pragma unroll
      for (int c = 1; c < kChunks; ++c) {
        conv0_a(a[c & 1], Xb, c, wq, g, t4);
        conv0_issue(acc[c & 1], a[c & 1], w0base);
        wgmma_wait<1>();
        fence_acc(acc[(c - 1) & 1]);
        conv0_store(acc[(c - 1) & 1], Ys, bias0, c - 1, wq, g, t4, top, left);
      }
      wgmma_wait<0>();
      fence_acc(acc[(kChunks - 1) & 1]);
      conv0_store(acc[(kChunks - 1) & 1], Ys, bias0, kChunks - 1, wq, g, t4, top, left);
    }
    bar_sync(bar, 128);  // this warpgroup's Y is complete

    // ---- 4. conv_1: warp wq -> output row p0 + 4 wg + wq, columns 0..15.
    // ldmatrix lane: matrix mi = lane / 8 (rows 8 (mi & 1).., channel group
    // 2 half + mi / 2), row lane % 8.
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    {
      const int mi = lane >> 3, qq = (lane & 7) + 8 * (mi & 1);
      const uint32_t ybase = smem_u32(Ys) + ((mi >> 1) * kU + qq) * 16;
      // The 18 k16 steps (K = 16 s.., s = 6 dy + 2 dx + half) in 6 groups of
      // 3 (one (dy, half) each), A in a[grp & 1]: a group's fragments are
      // loaded and issued before the group two back is waited for.
      uint32_t a[2][3][4];
#pragma unroll
      for (int grp = 0; grp < 6; ++grp) {
        const int dy = grp >> 1, half = grp & 1;
        if (grp >= 2) wgmma_wait<1>();  // group grp - 2 has read a[grp & 1]
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          ldmatrix_x4(a[grp & 1][dx],
                      ybase + (2 * wq + dy) * kYRowBytes +
                          (((dx & 1) * 4 + 2 * half) * kU + (dx >> 1)) * 16);
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          wgmma_n64k16(acc, a[grp & 1][dx],
                       smem_desc(w1base + (6 * dy + 2 * dx + half) * 2048, 1024, 128,
                                 kInterleave));
        wgmma_commit();
      }
      wgmma_wait<0>();
    }
    fence_acc(acc);

    // ---- 5. epilogue: + b1, leaky, bf16, staged in Y, 16-byte stores.
    bar_sync(bar, 128);  // this warpgroup's taps have read Y
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int c = 8 * (i >> 2) + 2 * t4;
      const float2 bias = *reinterpret_cast<const float2*>(b1s + c);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(Ys + (16 * wq + g + 8 * h) * kOS + 2 * c) =
            pack_bf16(leaky(acc[i + 2 * h] + bias.x), leaky(acc[i + 2 * h + 1] + bias.y));
    }
    bar_sync(bar, 128);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = wtid + 128 * k, r = idx >> 3, c16 = idx & 7;
      const int p = p0 + 4 * wg + (r >> 4), q = q0 + (r & 15);
      if (p < sh.gs && q < sh.gs)
        *reinterpret_cast<uint4*>(
            out + ((static_cast<long long>(b) * sh.gs + p) * sh.gs + q) * kC1 + 8 * c16) =
            *reinterpret_cast<const uint4*>(Ys + r * kOS + 16 * c16);
    }
  }
}

}  // namespace

// x (B, S, S, 3) f32 NHWC, S even, B <= 65,535; w0 (32, 48) bf16
// [cout][16 dy + 4 dx + cin], zero at dx = 3 and cin = 3; b0 (32,) f32;
// w1 (64, 288) bf16 [cout][(dy*3+dx)*32+cin]; b1 (64,) f32;
// out (B, S/2, S/2, 64) bf16. All contiguous on one device, 16-byte
// aligned. Launches on `stream`; returns cudaGetLastError() (0 on success)
// or kErrTensorMap when x's tensor map cannot be encoded.
extern "C" int fvy_front_fused(const float* x, const uint16_t* w0, const float* b0,
                               const uint16_t* w1, const float* b1, uint16_t* out,
                               int batch, int s, void* stream) {
  if (batch < 0 || batch > 65535 || s < 2 || s % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  FrontShape sh;
  sh.s = s;
  sh.gs = s / 2;
  sh.tiles_w = (sh.gs + kTC - 1) / kTC;
  sh.tiles_h = (sh.gs + kTR - 1) / kTR;
  sh.tiles = batch * sh.tiles_h * sh.tiles_w;
  sh.use_tma = s % 4 == 0;  // TMA wants a row pitch (12 S bytes) of 16-byte multiples
  CUtensorMap xmap{};
  if (sh.use_tma) {
    const uint64_t dims[3] = {static_cast<uint64_t>(s) * 3, static_cast<uint64_t>(s),
                              static_cast<uint64_t>(batch)};
    const uint64_t strides[2] = {static_cast<uint64_t>(s) * 12,
                                 static_cast<uint64_t>(s) * s * 12};
    const uint32_t box[3] = {kXF, kXR, 1u};
    const uint32_t es[3] = {1u, 1u, 1u};
    if (encode_tiled(&xmap, x, 3, dims, strides, box, es, 0,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32) != 0)
      return kErrTensorMap;
  }
  cudaError_t e = cudaFuncSetAttribute(
      front_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, front_fused_kernel,
                                                           kThreads, kSmem)) != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  front_fused_kernel<<<sh.tiles < fit ? sh.tiles : fit, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(xmap, x, w0, b0, w1, b1, out, sh);
  return static_cast<int>(cudaGetLastError());
}
