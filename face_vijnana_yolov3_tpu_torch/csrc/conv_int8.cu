// int8 convolution with its requantizing epilogue fused, as an implicit GEMM
// on Hopper's warpgroup int8 product (wgmma).
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
// order (ky, kx, ci) (weights stored [Cout][K], OHWI: K-major, as is the
// NHWC activation, which is what 8-bit wgmma takes).
//
// What bounds it on an H100: 2*M*N*K int8 operations against 1,979 TOP/s,
// and the bytes (each activation read once, each output written once) against
// 3.35 TB/s. At the trunk's stride-2 and 3x3 convs the two are within a
// factor of 2-3 of each other; conv_0 (Cin 3, K 27) is bound by writing its
// 32-channel output. The design keeps the tensor cores fed and every global
// access wide:
//
// conv_tma_kernel (Cin a multiple of 32). A tile is 128 output pixels x BN
// channels (BN 32, 64 or 128). The 128 pixels are a rectangle of TH x TW
// output pixels of one image (TW*TH <= 128, chosen per shape by
// ops/conv_int8.launch_config to waste the fewest rows), because a tiled
// 4-D tensor map over (C, W, H, B) then gives each (tap, channel chunk) as
// ONE TMA box: start (c0, x0*s - pad + kx, y0*s - pad + ky, b), box
// (BKc, TW*s, TH*s, 1) with element strides (1, s, s, 1), so stride 2 is
// TMA's traversal stride and the zero padding is its out-of-bounds fill
// (negative coordinates included). Tiled maps were chosen over im2col-mode
// maps because their semantics are plain coordinates, which the CPU tests
// walk in numpy; the cost is ragged rectangles at 13^2 and 26^2 (66-78 % of
// the rows are pixels). BKc, the largest of 128, 64 and 32 bytes dividing
// Cin, is also the swizzle width, so a box row is one swizzle row; a stage
// holds up to 128 bytes of K (the most boxes of A and of B, up to 128 / BKc,
// that divide the tile's K), so a stage carries 3-4 k32 steps even at Cin
// 32 (two at Cin 64 with a 3x3), as straight-line code. The blocks are
// persistent (as many as fit, each walking tiles blockIdx.x, + gridDim.x,
// ...). One producer warp keeps a ring of 96 KB (3-8 stages) full across
// tiles, guarded by full/empty mbarriers; two consumer warpgroups (64 pixel
// rows each) issue a stage's k32 steps and keep one wgmma group in flight.
// No block-wide barrier runs on a K step. At the trunk's shapes the
// epilogue costs as much as the products, so its latency is kept off the
// critical path: a tile's skip rows and channel parameters are loaded into
// registers when the tile starts, staged in shared memory after its
// products, requantized without a branch per value, and the tile leaves as
// 16-byte rows while the producer already loads the next tile.
//
// conv_gather_kernel (conv_0 and any Cin that TMA cannot box: its inner box
// must be >= 16 bytes and its pixel stride a multiple of 16). A block takes a
// band of R output rows of one image: it copies the haloed input band into
// shared memory with 16-byte loads (one contiguous byte range of NHWC), then
// each warpgroup assembles 64 im2col rows of 32 K bytes at a time (K padded
// to a multiple of 32 with zeros, through a per-block table of tap offsets),
// in the no-swizzle K-major layout, and runs one m64nNk32 wgmma step per 32
// bytes of K (one for conv_0). Its output leaves as 16-byte rows.

#include <algorithm>

#include "int8_mma.cuh"

namespace {

using namespace fvy;

constexpr int kBM = 128;           // output pixels per TMA tile
constexpr int kMaxStages = 8;      // TMA ring depth, at most
constexpr int kRingBytes = 96 * 1024;  // ring budget (3 stages of 128-byte K)
constexpr int kStageK = 128;           // K bytes a stage holds, at most
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kTmaThreads = kConsumers + 32;  // + one producer warp
constexpr int kGatherMaxK = 1024;  // K bytes the gather kernel's table holds

struct ConvShape {
  int batch, h, w, cin, ho, wo, cout, k, stride, pad, kdim;
  int tw, th, tiles_w, tiles_h;  // TMA: output rectangle per tile
  int bkc, chunks, ksteps;       // TMA: K bytes per stage, per tap, stages
  int boxes, stages;             // TMA: (tap, chunk) boxes a stage, ring depth
  int rows, bands;               // gather: output rows per block, per image
};

// NK: k32 steps a stage holds (boxes * BKc / 32), a compile-time count so
// that a stage's wgmma sequence is straight-line code (ptxas serializes
// wgmma issued from a loop of runtime length).
template <int BN, int NK>
__global__ void __launch_bounds__(kTmaThreads)
conv_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ w_scale, const float* __restrict__ bias,
                const signed char* __restrict__ skip,
                const float* __restrict__ skip_s,
                const float* __restrict__ inv_out, signed char* __restrict__ out,
                ConvShape s, int leaky) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  // A stage: `boxes` A boxes (kBM x BKc), then as many B boxes (BN x BKc).
  const int a_bytes = kBM * s.bkc, b_bytes = BN * s.bkc;
  const int stage_bytes = s.boxes * (a_bytes + b_bytes);
  signed char* S = reinterpret_cast<signed char*>(smem + s.stages * stage_bytes);
  float* P = reinterpret_cast<float*>(S + kBM * (BN + 16));
  uint64_t* full = reinterpret_cast<uint64_t*>(P + 4 * BN);
  uint64_t* empty = full + kMaxStages;
  const int tiles_n = (s.cout + BN - 1) / BN;
  const int tiles = s.batch * s.tiles_h * s.tiles_w * tiles_n;

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Tile t: output channels (t % tiles_n) * BN.., then the rectangle
  // (tx, ty) of image b; consecutive tiles share their activation boxes.
  auto decode = [&](int t, int& tx, int& ty, int& b, int& n0) {
    n0 = (t % tiles_n) * BN;
    t /= tiles_n;
    tx = t % s.tiles_w;
    t /= s.tiles_w;
    ty = t % s.tiles_h;
    b = t / s.tiles_h;
  };

  if (threadIdx.x >= kConsumers) {
    // Producer warp: lane 0 keeps the ring full across this block's tiles,
    // so the next tile's boxes arrive while the consumers run an epilogue.
    if (threadIdx.x == kConsumers) {
      const uint32_t box_tx = (s.tw * s.th + BN) * s.bkc;
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tx, ty, b, n0;
        decode(t, tx, ty, b, n0);
        const int x0 = tx * s.tw * s.stride - s.pad, y0 = ty * s.th * s.stride - s.pad;
        for (int kt = 0; kt < s.ksteps; kt += s.boxes, ++it) {
          const int st = it % s.stages;
          mbar_wait(&empty[st], ((it / s.stages) & 1) ^ 1);
          unsigned char* a = smem + st * stage_bytes;
          mbar_expect_tx(&full[st], s.boxes * box_tx);
          for (int j = 0; j < s.boxes; ++j) {
            const int tap = (kt + j) / s.chunks, c0 = (kt + j - tap * s.chunks) * s.bkc;
            const int ky = tap / s.k, kx = tap - ky * s.k;
            tma_load_4d(a + j * a_bytes, &xmap, c0, x0 + kx, y0 + ky, b, &full[st]);
            tma_load_2d(a + s.boxes * a_bytes + j * b_bytes, &wmap, tap * s.cin + c0, n0,
                        &full[st]);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroups: wg 0 takes tile rows 0..63, wg 1 rows 64..127.
  const int wg = threadIdx.x >> 7;
  const int layout = swizzle_layout(s.bkc);
  const uint32_t sbo = 8 * s.bkc;
  const int tw = s.tw, rows = s.tw * s.th;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int tx, ty, b, n0;
    decode(t, tx, ty, b, n0);
    const int oy0 = ty * s.th, ox0 = tx * s.tw;
    auto pix = [&](int r) -> long long {
      const int oy = oy0 + r / tw, ox = ox0 + r % tw;
      if (r >= rows || oy >= s.ho || ox >= s.wo) return -1;
      return (static_cast<long long>(b) * s.ho + oy) * s.wo + ox;
    };
    // The epilogue's inputs, loaded now: their latency hides behind the products.
    TileSkip<BN, kBM, kConsumers> sk;
    if (skip != nullptr) sk.load(pix, skip, s.cout, n0, threadIdx.x);
    TileParams<BN, 4, kConsumers> prm;
    prm.load({w_scale, bias, skip_s, inv_out}, n0, s.cout, threadIdx.x);

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_acc(acc);
    int prev = -1;
    for (int kt = 0; kt < s.ksteps; kt += s.boxes, ++it) {
      const int st = it % s.stages;
      mbar_wait(&full[st], (it / s.stages) & 1);
      const uint32_t a = smem_u32(smem + st * stage_bytes) + wg * 64 * s.bkc;
      const uint32_t bb = smem_u32(smem + st * stage_bytes) + s.boxes * a_bytes;
      const int per_box = s.bkc / 32;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < NK; ++q) {
        const int j = q / per_box, o = 32 * (q - j * per_box);
        wgmma_k32(acc, smem_desc(a + j * a_bytes + o, 16, sbo, layout),
                  smem_desc(bb + j * b_bytes + o, 16, sbo, layout));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done with it
      if (prev >= 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
      prev = st;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);

    bar_sync(1, kConsumers);  // the previous tile has left S and P
    if (skip != nullptr) sk.store(S, threadIdx.x);
    prm.store(P, threadIdx.x);
    bar_sync(1, kConsumers);
    requant_tile<BN>(acc, 64 * wg, S, P, skip != nullptr, leaky != 0);
    bar_sync(1, kConsumers);
    store_tile<BN, kBM, kConsumers>(pix, S, out, s.cout, n0, threadIdx.x);
  }
}

template <int BN>
__global__ void __launch_bounds__(kConsumers)
conv_gather_kernel(const signed char* __restrict__ x,
                   const signed char* __restrict__ wq,
                   const float* __restrict__ w_scale, const float* __restrict__ bias,
                   const signed char* __restrict__ skip,
                   const float* __restrict__ skip_s,
                   const float* __restrict__ inv_out, signed char* __restrict__ out,
                   ConvShape s, int leaky) {
  extern __shared__ unsigned char smem_raw[];
  // Per warpgroup: A [2][64][16], B [2][BN][16] (no-swizzle K-major), the
  // epilogue's staging [64][BN + 16] and parameters [4][BN]; then the K
  // table; then the band.
  constexpr int kA = 2 * 64 * 16, kB = 2 * BN * 16, kStage = 64 * (BN + 16);
  constexpr int kPerWg = kA + kB + kStage + 16 * BN;
  unsigned char* wg_smem = smem_raw + (threadIdx.x >> 7) * kPerWg;
  unsigned char* As = wg_smem;
  unsigned char* Bs = wg_smem + kA;
  signed char* S = reinterpret_cast<signed char*>(wg_smem + kA + kB);
  float* P = reinterpret_cast<float*>(wg_smem + kA + kB + kStage);
  int* koff = reinterpret_cast<int*>(smem_raw + 2 * kPerWg);
  int* kyx = koff + kGatherMaxK;
  unsigned char* band = reinterpret_cast<unsigned char*>(kyx + kGatherMaxK);

  const int b = blockIdx.x / s.bands;
  const int oy0 = (blockIdx.x - b * s.bands) * s.rows;
  const int rows_out = min(s.rows, s.ho - oy0);
  const int n0 = blockIdx.y * BN;
  const int kpad = (s.kdim + 31) & ~31;

  // The band: input rows [ylo, yhi) of image b, one contiguous byte range,
  // copied with 16-byte loads from the 16-byte boundary at or below it.
  const int ylo = max(oy0 * s.stride - s.pad, 0);
  const int yhi = min((oy0 + rows_out - 1) * s.stride - s.pad + s.k, s.h);
  const long long row_bytes = static_cast<long long>(s.w) * s.cin;
  const long long start = (static_cast<long long>(b) * s.h + ylo) * row_bytes;
  const long long end = (static_cast<long long>(b) * s.h + yhi) * row_bytes;
  const long long total = static_cast<long long>(s.batch) * s.h * row_bytes;
  const long long a0 = start & ~15LL;
  for (long long off = a0 + 16LL * threadIdx.x; off < end; off += 16LL * kConsumers) {
    unsigned char* d = band + (off - a0);
    if (off + 16 <= total) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(x + off);
    } else {
      for (int j = 0; j < 16; ++j) d[j] = off + j < total ? x[off + j] : 0;
    }
  }
  // K table: byte kk of an im2col row reads band offset koff[kk] from the
  // pixel's top-left tap, at tap (ky, kx) = kyx[kk] (-1: K padding).
  for (int kk = threadIdx.x; kk < kpad; kk += kConsumers) {
    if (kk < s.kdim) {
      const int tap = kk / s.cin, ci = kk - tap * s.cin;
      const int ky = tap / s.k, kx = tap - ky * s.k;
      koff[kk] = static_cast<int>((ky * static_cast<long long>(s.w) + kx) * s.cin + ci);
      kyx[kk] = (ky << 8) | kx;
    } else {
      koff[kk] = 0;
      kyx[kk] = -1;
    }
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127;
  const int bar = 2 + wg;
  const int m_total = rows_out * s.wo;
  const int ksteps = kpad / 32;
  const int p = lt >> 1, half = lt & 1;  // A: pixel row p, K bytes 16*half..
  const long long band0 = start - a0;
  TileParams<BN, 4, 128> prm;  // the same channels for every chunk
  prm.load({w_scale, bias, skip_s, inv_out}, n0, s.cout, lt);
  prm.store(P, lt);  // read after the first chunk's barriers

  for (int chunk = wg; chunk * 64 < m_total; chunk += 2) {
    const long long pix0 = (static_cast<long long>(b) * s.ho + oy0) * s.wo + chunk * 64;
    auto pix = [&](int r) -> long long {
      return chunk * 64 + r < m_total ? pix0 + r : -1;
    };
    TileSkip<BN, 64, 128> sk;
    if (skip != nullptr) sk.load(pix, skip, s.cout, n0, lt);
    const int m = chunk * 64 + p;
    const bool m_ok = m < m_total;
    const int oy = oy0 + (m_ok ? m / s.wo : 0), ox = m_ok ? m % s.wo : 0;
    const int iy0 = oy * s.stride - s.pad, ix0 = ox * s.stride - s.pad;
    const long long pbase = band0 + (static_cast<long long>(iy0 - ylo) * s.w + ix0) * s.cin;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_acc(acc);
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kk = ks * 32 + half * 16 + j;
        const int yx = kyx[kk];
        if (!m_ok || yx < 0) continue;
        const int iy = iy0 + (yx >> 8), ix = ix0 + (yx & 255);
        if (iy < 0 || iy >= s.h || ix < 0 || ix >= s.w) continue;
        words[j >> 2] |= static_cast<uint32_t>(band[pbase + koff[kk]]) << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(As + half * 64 * 16 + p * 16) =
          make_uint4(words[0], words[1], words[2], words[3]);
      if (ksteps > 1 || chunk == wg) {  // one K step: B stays for every chunk
        for (int i = lt; i < 2 * BN; i += 128) {
          const int n = i >> 1, hb = i & 1;
          uint32_t wv[4] = {0u, 0u, 0u, 0u};
          if (n0 + n < s.cout) {
            const signed char* wr = wq + static_cast<long long>(n0 + n) * s.kdim;
            for (int j = 0; j < 16; ++j) {
              const int kk = ks * 32 + hb * 16 + j;
              if (kk < s.kdim)
                wv[j >> 2] |= static_cast<uint32_t>(static_cast<unsigned char>(wr[kk]))
                              << (8 * (j & 3));
            }
          }
          *reinterpret_cast<uint4*>(Bs + hb * BN * 16 + n * 16) =
              make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
      }
      fence_proxy_async();
      bar_sync(bar, 128);
      wgmma_fence();
      wgmma_k32(acc, smem_desc(smem_u32(As), 64 * 16, 128, kInterleave),
                smem_desc(smem_u32(Bs), BN * 16, 128, kInterleave));
      wgmma_commit();
      wgmma_wait<0>();
      bar_sync(bar, 128);  // the warpgroup is done with As/Bs
    }
    fence_acc(acc);
    // The K loop's barriers ordered the previous chunk's reads of S first.
    if (skip != nullptr) {
      sk.store(S, lt);
      bar_sync(bar, 128);
    }
    requant_tile<BN>(acc, 0, S, P, skip != nullptr, leaky != 0);
    bar_sync(bar, 128);
    store_tile<BN, 64, 128>(pix, S, out, s.cout, n0, lt);
  }
}

constexpr int kGatherSmemFixed = 2 * (2 * 64 * 16) + 2 * 4 * kGatherMaxK;

int gather_smem(int bn, long long band_bytes) {
  return static_cast<int>(kGatherSmemFixed + 2 * (2 * bn * 16 + 64 * (bn + 16) + 16 * bn) +
                          band_bytes + 32);
}

template <int BN, int NK>
int launch_tma(const signed char* x, const signed char* wq, const float* w_scale,
               const float* bias, const signed char* skip, const float* skip_s,
               const float* inv_out, signed char* out, const ConvShape& s,
               int leaky, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {static_cast<uint64_t>(s.cin), static_cast<uint64_t>(s.w),
                             static_cast<uint64_t>(s.h), static_cast<uint64_t>(s.batch)};
  const uint64_t xstrides[3] = {static_cast<uint64_t>(s.cin),
                                static_cast<uint64_t>(s.w) * s.cin,
                                static_cast<uint64_t>(s.h) * s.w * s.cin};
  const uint32_t xbox[4] = {static_cast<uint32_t>(s.bkc),
                            static_cast<uint32_t>(s.tw * s.stride),
                            static_cast<uint32_t>(s.th * s.stride), 1u};
  const uint32_t xes[4] = {1u, static_cast<uint32_t>(s.stride),
                           static_cast<uint32_t>(s.stride), 1u};
  const uint64_t wdims[2] = {static_cast<uint64_t>(s.kdim), static_cast<uint64_t>(s.cout)};
  const uint64_t wstrides[1] = {static_cast<uint64_t>(s.kdim)};
  const uint32_t wbox[2] = {static_cast<uint32_t>(s.bkc), static_cast<uint32_t>(BN)};
  const uint32_t wes[2] = {1u, 1u};
  if (encode_tiled(&xmap, x, 4, xdims, xstrides, xbox, xes, s.bkc) != 0 ||
      encode_tiled(&wmap, wq, 2, wdims, wstrides, wbox, wes, s.bkc) != 0)
    return kErrTensorMap;
  ConvShape sh = s;
  sh.boxes = NK * 32 / s.bkc;
  const int stage_bytes = sh.boxes * (kBM + BN) * s.bkc;
  sh.stages = std::max(2, std::min(kMaxStages, kRingBytes / stage_bytes));
  const int smem =
      1024 + sh.stages * stage_bytes + kBM * (BN + 16) + 16 * BN + 2 * kMaxStages * 8;
  cudaError_t e = cudaFuncSetAttribute(conv_tma_kernel<BN, NK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // Persistent: as many blocks as fit on the card at once, each walking
  // tiles blockIdx.x, + gridDim.x, ...
  // (queried once per shared-memory size: the host's launch cost counts
  // wherever the kernel is short)
  static int sms = 0, per_sm = 0, per_sm_smem = -1;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
  }
  if (per_sm_smem != smem) {
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_tma_kernel<BN, NK>,
                                                           kTmaThreads, smem)) != cudaSuccess)
      return static_cast<int>(e);
    per_sm_smem = smem;
  }
  const long long tiles = static_cast<long long>(s.batch) * s.tiles_h * s.tiles_w *
                          ((s.cout + BN - 1) / BN);
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  conv_tma_kernel<BN, NK><<<static_cast<unsigned>(tiles < fit ? tiles : fit), kTmaThreads,
                        smem, st>>>(xmap, wmap, w_scale, bias, skip, skip_s, inv_out,
                                    out, sh, leaky);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_tma_bn(const signed char* x, const signed char* wq, const float* w_scale,
                  const float* bias, const signed char* skip, const float* skip_s,
                  const float* inv_out, signed char* out, const ConvShape& s, int leaky,
                  cudaStream_t st) {
  if (s.cout <= 32)
    return launch_tma<32, NK>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
  if (s.cout <= 64)
    return launch_tma<64, NK>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
  return launch_tma<128, NK>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
}

int launch_tma_n(int nk, const signed char* x, const signed char* wq, const float* w_scale,
                 const float* bias, const signed char* skip, const float* skip_s,
                 const float* inv_out, signed char* out, const ConvShape& s, int leaky,
                 cudaStream_t st) {
  switch (nk) {
    case 1:
      return launch_tma_bn<1>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
    case 2:
      return launch_tma_bn<2>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
    case 3:
      return launch_tma_bn<3>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
    default:
      return launch_tma_bn<4>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
  }
}

template <int BN>
int launch_gather(const signed char* x, const signed char* wq, const float* w_scale,
                  const float* bias, const signed char* skip, const float* skip_s,
                  const float* inv_out, signed char* out, const ConvShape& s,
                  int leaky, cudaStream_t st) {
  const int in_rows = (s.rows - 1) * s.stride + s.k;
  const int smem = gather_smem(BN, static_cast<long long>(in_rows) * s.w * s.cin);
  cudaError_t e = cudaFuncSetAttribute(conv_gather_kernel<BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(s.batch * s.bands),
                  static_cast<unsigned>((s.cout + BN - 1) / BN));
  conv_gather_kernel<BN><<<grid, kConsumers, smem, st>>>(
      x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, Cin) int8; wq (Cout, k, k, Cin) int8; w_scale, bias, inv_out
// (Cout,) f32; skip (B, Ho, Wo, Cout) int8 and skip_s (Cout,) f32, or both
// null; out (B, Ho, Wo, Cout) int8. All contiguous, 16-byte aligned, on one
// device. Cin a multiple of 32: the TMA kernel on tiles of tile_h x tile_w
// output pixels (tile_w * tile_h <= 128); otherwise the gather kernel on
// bands of tile_h output rows (tile_w unused). Launches on `stream`; returns
// cudaGetLastError() (0 on success), or -1 if a tensor map cannot be encoded.
extern "C" int fvy_conv_int8(const signed char* x, const signed char* wq,
                             const float* w_scale, const float* bias,
                             const signed char* skip, const float* skip_s,
                             const float* inv_out, signed char* out, int batch,
                             int h, int w, int cin, int cout, int k, int stride,
                             int leaky, int tile_w, int tile_h, void* stream) {
  if ((k != 1 && k != 3) || (stride != 1 && stride != 2) || batch < 0 ||
      h < 1 || w < 1 || cin < 1 || cout < 1 || tile_h < 1 ||
      ((skip == nullptr) != (skip_s == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvShape s{};
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
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cin % 32 == 0) {
    if (tile_w < 1 || tile_w * tile_h > kBM || tile_w * stride > 256 ||
        tile_h * stride > 256)
      return static_cast<int>(cudaErrorInvalidValue);
    s.tw = tile_w;
    s.th = tile_h;
    s.tiles_w = (s.wo + tile_w - 1) / tile_w;
    s.tiles_h = (s.ho + tile_h - 1) / tile_h;
    s.bkc = cin % 128 == 0 ? 128 : cin % 64 == 0 ? 64 : 32;
    s.chunks = cin / s.bkc;
    s.ksteps = k * k * s.chunks;
    // Boxes a stage: the most, up to kStageK bytes of K, that divide the
    // tile's boxes, so that every stage is full.
    int boxes = std::max(1, kStageK / s.bkc);
    while (s.ksteps % boxes != 0) --boxes;
    return launch_tma_n(boxes * s.bkc / 32, x, wq, w_scale, bias, skip, skip_s, inv_out,
                        out, s, leaky, st);
  }
  if (s.kdim > kGatherMaxK || tile_h > s.ho) return static_cast<int>(cudaErrorInvalidValue);
  s.rows = tile_h;
  s.bands = (s.ho + tile_h - 1) / tile_h;
  if (cout <= 32)
    return launch_gather<32>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
  return launch_gather<64>(x, wq, w_scale, bias, skip, skip_s, inv_out, out, s, leaky, st);
}
