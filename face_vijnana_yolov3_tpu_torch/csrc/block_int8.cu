// One whole int8 Darknet residual block (1x1 -> 3x3 -> skip add) in one
// launch, on Hopper's warpgroup int8 product (wgmma) fed by TMA.
//
// Replaces face_vijnana_yolov3_tpu/ops/pallas_block.py::_block_kernel (and its
// pallas_call in fused_block_int8):
//   y1  = requant(leaky(fma(x_q @ w1, ws1, b1)), inv_s_mid)      (kept on chip)
//   out = requant(fma(x_q, skip_s, leaky(fma(conv3x3(y1, w2), ws2, b2))), inv_s_out)
// with the zero padding of the 3x3 applied to the int8 intermediate, and the
// epilogues of int8_mma.cuh (bit-exact with the JAX package's jitted
// program: same int32 sums, the same fused multiply-adds and roundings).
//
// What bounds it on an H100: 2*H*W*(C*Ch + 9*Ch*C) int8 operations per image
// against 1,979 TOP/s, far above its bytes (x read once, out written once):
// compute-bound, so the design is about keeping the tensor cores fed.
//
// Design. The TPU kernel flattened H*W into sublanes and shifted each tap by
// slice + concat, because Mosaic had no strided tap access. Here a block
// takes a band of R output rows of one image and C / n_split output
// channels (ops/block_int8.launch_config picks R and n_split per shape):
//   1. The 1x1 for the band's rows plus a one-row halo above and below: a
//      GEMM over those (R+2)*W pixels, which are contiguous in NHWC, with x
//      and w1 brought in as 128x128-byte TMA boxes (128-byte swizzle). Its
//      epilogue requantizes into Y in shared memory, laid out K-major without
//      swizzle so that wgmma reads the 3x3's A operand straight from it:
//        Y[Ch/16][P][16 bytes], pixel (yr, yc) of the (R+2) x (W+2) band at
//        q = yr*(W+2) + yc, channel k at (k/16)*LBO + 16*q + k%16,
//        LBO = 16*P, SBO = 128,
//      with zero border columns, zero rows outside the image and zero slack.
//   2. The 3x3 as 9*Ch/32 wgmma k-steps whose A descriptor starts at
//      16*(q0 + ky*(W+2) + kx): a tap is only a start-address offset, no
//      im2col and no shifted copy (what PROFILE.md:674-676 says Mosaic could
//      not express). M runs over the padded width, R*(W+2) rows, so that 64
//      consecutive rows are 64 uniformly spaced pixels of Y; the epilogue
//      drops the two junk columns of each row (4 % extra at 52^2, 8 % at
//      26^2, 15 % at 13^2). w2 streams through the same TMA ring, two
//      128x128-byte boxes (two K chunks) a stage where Ch allows.
// One producer warp issues every TMA box of both phases into a ring of
// kStages stages guarded by full/empty mbarriers (it runs ahead into phase
// 2's w2 while phase 1 finishes); two consumer warpgroups issue the wgmma
// (64 rows x 128 channels each per 128x128 tile) and keep one group in
// flight. The only block-wide barriers are after Y's zeroing and between the
// phases (with fence.proxy.async: Y is written by st.shared and read by
// wgmma through the async proxy). Each tile's skip rows and channel
// parameters are loaded into registers when the tile starts, so their
// latency hides behind its products; phase 2's tiles leave through shared
// memory as 16-byte rows.
// The 1x1 halo rows are computed by both neighbouring bands, and a block
// that takes a slice of the output channels (n_split > 1, to fill the SMs
// at stage 5) recomputes the whole 1x1: launch_config counts both.

#include "int8_mma.cuh"

namespace {

using namespace fvy;

constexpr int kT = 128;                      // tile: 128 pixels x 128 channels
constexpr int kStages = 3;                   // TMA ring depth
constexpr int kStageBytes = 2 * kT * kT;     // an A box and a B box of 128 x 128
constexpr int kBoxBytes = kT * kT;
constexpr int kStagingBytes = kT * (kT + 16);
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr long long kMaxSmem = 232448;       // an H100 block's shared memory

struct BlockShape {
  int batch, h, w, c, ch, rows, n_split, ypix;
};

// Y's pixel count P: every row phase 2's 128-row tiles read, at any tap.
__host__ __device__ inline int y_pixels(int rows, int w) {
  const int m2 = (rows * (w + 2) + kT - 1) / kT * kT;
  return (m2 + 2 * (w + 2) + 2 + 7) & ~7;
}

__host__ inline long long block_smem(int w, int ch, int rows) {
  return 1024 + static_cast<long long>(kStages) * kStageBytes +
         static_cast<long long>(ch) * y_pixels(rows, w) + kStagingBytes + 16 * kT +
         2 * kStages * 8;
}

// P2: w2 boxes a phase-2 stage holds (2 where 9*Ch/128 is even, else 1), a
// compile-time count so that a stage's wgmma sequence is straight-line code.
template <int P2>
__global__ void __launch_bounds__(kThreads)
block_int8_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap w2map,
                  const signed char* __restrict__ x,
                  const float* __restrict__ ws1, const float* __restrict__ b1,
                  const float* __restrict__ inv_mid,
                  const float* __restrict__ ws2, const float* __restrict__ b2,
                  const float* __restrict__ skip_s,
                  const float* __restrict__ inv_out,
                  signed char* __restrict__ out, BlockShape s) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* Y = ring + kStages * kStageBytes;
  signed char* S = reinterpret_cast<signed char*>(Y + static_cast<size_t>(s.ch) * s.ypix);
  float* P = reinterpret_cast<float*>(S + kStagingBytes);  // a tile's channel parameters
  uint64_t* full = reinterpret_cast<uint64_t*>(P + 4 * kT);
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z;
  const int r0 = blockIdx.x * s.rows;
  const int rows_out = min(s.rows, s.h - r0);
  const int rlo = max(r0 - 1, 0), rhi = min(r0 + rows_out + 1, s.h);
  const int wp = s.w + 2;
  // Phase 1: m1 pixels (image rows rlo..rhi-1), Ch channels, K = C.
  const int m1 = (rhi - rlo) * s.w;
  const int mt1 = (m1 + kT - 1) / kT, nt1 = s.ch / kT, kt1 = s.c / kT;
  const int pix0 = (b * s.h + rlo) * s.w;
  // Phase 2: m2 padded-width rows, C / n_split channels from c_lo, K = 9 Ch.
  const int m2 = rows_out * wp;
  const int mt2 = (m2 + kT - 1) / kT;
  const int c_per = s.c / s.n_split, c_lo = blockIdx.y * c_per;
  const int nt2 = c_per / kT, kc = s.ch / kT, kt2 = 9 * kc;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warp: lane 0 walks both phases' tiles in the consumers' order.
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int mt = 0; mt < mt1; ++mt)
        for (int nt = 0; nt < nt1; ++nt)
          for (int kt = 0; kt < kt1; ++kt, ++it) {
            const int st = it % kStages;
            mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
            unsigned char* a = ring + st * kStageBytes;
            mbar_expect_tx(&full[st], 2 * kBoxBytes);
            tma_load_2d(a, &xmap, kt * kT, pix0 + mt * kT, &full[st]);
            tma_load_2d(a + kBoxBytes, &w1map, kt * kT, nt * kT, &full[st]);
          }
      for (int mt = 0; mt < mt2; ++mt)
        for (int nt = 0; nt < nt2; ++nt)
          for (int kt = 0; kt < kt2; kt += P2, ++it) {
            const int st = it % kStages;
            mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&full[st], P2 * kBoxBytes);
            for (int j = 0; j < P2; ++j)
              tma_load_2d(ring + st * kStageBytes + j * kBoxBytes, &w2map, (kt + j) * kT,
                          c_lo + nt * kT, &full[st]);
          }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ring_u32 = smem_u32(ring), y_u32 = smem_u32(Y);
  const uint32_t lbo = 16u * s.ypix;

  const size_t ybytes = static_cast<size_t>(s.ch) * s.ypix;
  for (size_t i = 16 * static_cast<size_t>(threadIdx.x); i < ybytes; i += 16 * kConsumers)
    *reinterpret_cast<uint4*>(Y + i) = make_uint4(0u, 0u, 0u, 0u);
  bar_sync(1, kConsumers);

  int acc[kT / 2];
  int it = 0;
  // One stage of the ring: wait for its boxes, issue its k32 products, let
  // the previous stage go once its products are done.
  auto consume = [&](int prev_st, auto&& issue) -> int {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    wgmma_fence();
    issue(ring_u32 + st * kStageBytes);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev_st >= 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[prev_st]);
    ++it;
    return st;
  };
  auto finish = [&](int last_st) {
    wgmma_wait<0>();
    fence_acc(acc);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[last_st]);
  };
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) acc[i] = 0;
    fence_acc(acc);
  };

  // ---- 1. the 1x1 into Y
  for (int mt = 0; mt < mt1; ++mt)
    for (int nt = 0; nt < nt1; ++nt) {
      TileParams<kT, 3, kConsumers> prm;
      prm.load({ws1, b1, inv_mid}, nt * kT, s.ch, threadIdx.x);
      zero();
      int st = -1;
      for (int kt = 0; kt < kt1; ++kt)
        st = consume(st, [&](uint32_t stage) {
          const uint32_t a = stage + wg * 64 * kT, bb = stage + kBoxBytes;
#pragma unroll
          for (int j = 0; j < kT / 32; ++j)
            wgmma_k32(acc, smem_desc(a + 32 * j, 16, 1024, kSwizzle128),
                      smem_desc(bb + 32 * j, 16, 1024, kSwizzle128));
        });
      finish(st);
      bar_sync(1, kConsumers);  // the previous tile is done with P
      prm.store(P, threadIdx.x);
      bar_sync(1, kConsumers);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * kT + 64 * wg + 16 * warp + g + 8 * h;
        if (p >= m1) continue;
        unsigned char* yp = Y + 16 * ((rlo - r0 + 1 + p / s.w) * wp + p % s.w + 1);
#pragma unroll
        for (int q = 0; q < kT / 8; ++q) {
          const int c = 8 * q + 2 * t, n = nt * kT + c;  // channels n, n + 1
          const int lo = static_cast<unsigned char>(requant(
              acc[4 * q + 2 * h], P[c], P[kT + c], true, false, 0.0f, 0.0f, P[2 * kT + c]));
          const int hi = static_cast<unsigned char>(
              requant(acc[4 * q + 2 * h + 1], P[c + 1], P[kT + c + 1], true, false, 0.0f,
                      0.0f, P[2 * kT + c + 1]));
          *reinterpret_cast<uint16_t*>(yp + (n >> 4) * lbo + (n & 15)) =
              static_cast<uint16_t>(lo | (hi << 8));
        }
      }
    }
  fence_proxy_async();
  bar_sync(1, kConsumers);

  // ---- 2. the 3x3 from Y, skip add, out
  for (int mt = 0; mt < mt2; ++mt)
    for (int nt = 0; nt < nt2; ++nt) {
      const int n0 = c_lo + nt * kT;
      auto pix = [&](int r) -> long long {
        const int qq = mt * kT + r;
        const int rr = qq / wp, cc = qq - rr * wp;
        if (qq >= m2 || cc >= s.w) return -1;
        return (static_cast<long long>(b) * s.h + r0 + rr) * s.w + cc;
      };
      // The epilogue's inputs, loaded now: their latency hides behind the products.
      TileSkip<kT, kT, kConsumers> sk;
      sk.load(pix, x, s.c, n0, threadIdx.x);
      TileParams<kT, 4, kConsumers> prm;
      prm.load({ws2, b2, skip_s, inv_out}, n0, s.c, threadIdx.x);
      zero();
      int st = -1;
      for (int kt = 0; kt < kt2; kt += P2)
        st = consume(st, [&](uint32_t stage) {
#pragma unroll
          for (int h = 0; h < P2; ++h) {
            const int tap = (kt + h) / kc, c0 = (kt + h - tap * kc) * kT;
            const int ky = tap / 3, kx = tap - 3 * ky;
            const uint32_t a = y_u32 + 16u * (mt * kT + 64 * wg + ky * wp + kx);
            const uint32_t bb = stage + h * kBoxBytes;
#pragma unroll
            for (int j = 0; j < kT / 32; ++j)
              wgmma_k32(acc, smem_desc(a + ((c0 + 32 * j) >> 4) * lbo, lbo, 128, kInterleave),
                        smem_desc(bb + 32 * j, 16, 1024, kSwizzle128));
          }
        });
      finish(st);
      bar_sync(1, kConsumers);  // the previous tile has left S and P
      sk.store(S, threadIdx.x);
      prm.store(P, threadIdx.x);
      bar_sync(1, kConsumers);
      requant_tile<kT>(acc, 64 * wg, S, P, true, true);
      bar_sync(1, kConsumers);
      store_tile<kT, kT, kConsumers>(pix, S, out, s.c, n0, threadIdx.x);
    }
}

}  // namespace

// x, out (B, H, W, C) int8; w1 (Ch, 1, 1, C) int8; w2 (C, 3, 3, Ch) int8;
// ws1, b1, inv_mid (Ch,) and ws2, b2, skip_s, inv_out (C,) f32. C and Ch
// multiples of 128; `rows` output rows per block; `n_split` blocks share
// each band's output channels (C / n_split a multiple of 128). All
// contiguous, 16-byte aligned, on one device. Launches on `stream`; returns
// cudaGetLastError() (0 on success), or -1 if a tensor map cannot be encoded.
extern "C" int fvy_block_int8(const signed char* x, const signed char* w1,
                              const signed char* w2, const float* ws1,
                              const float* b1, const float* inv_mid,
                              const float* ws2, const float* b2,
                              const float* skip_s, const float* inv_out,
                              signed char* out, int batch, int h, int w, int c,
                              int ch, int rows, int n_split, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || c % kT != 0 || ch % kT != 0 || c < kT ||
      ch < kT || rows < 1 || rows > h || n_split < 1 || c % n_split != 0 ||
      (c / n_split) % kT != 0 || block_smem(w, ch, rows) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  CUtensorMap xmap, w1map, w2map;
  const uint32_t box[2] = {kT, kT}, es[2] = {1u, 1u};
  const uint64_t xdims[2] = {static_cast<uint64_t>(c),
                             static_cast<uint64_t>(batch) * h * w};
  const uint64_t xstr[1] = {static_cast<uint64_t>(c)};
  const uint64_t w1dims[2] = {static_cast<uint64_t>(c), static_cast<uint64_t>(ch)};
  const uint64_t w2dims[2] = {9ull * ch, static_cast<uint64_t>(c)};
  const uint64_t w2str[1] = {9ull * ch};
  if (encode_tiled(&xmap, x, 2, xdims, xstr, box, es, 128) != 0 ||
      encode_tiled(&w1map, w1, 2, w1dims, xstr, box, es, 128) != 0 ||
      encode_tiled(&w2map, w2, 2, w2dims, w2str, box, es, 128) != 0)
    return kErrTensorMap;
  const int smem = static_cast<int>(block_smem(w, ch, rows));
  auto kernel = (9 * ch / kT) % 2 == 0 ? block_int8_kernel<2> : block_int8_kernel<1>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BlockShape s{batch, h, w, c, ch, rows, n_split, y_pixels(rows, w)};
  const dim3 grid(static_cast<unsigned>((h + rows - 1) / rows),
                  static_cast<unsigned>(n_split), static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, w1map, w2map, x, ws1, b1, inv_mid, ws2, b2, skip_s, inv_out, out, s);
  return static_cast<int>(cudaGetLastError());
}
