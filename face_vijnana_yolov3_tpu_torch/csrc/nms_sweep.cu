// Greedy NMS suppression sweep as a bitmask build and a one-warp scan, one
// thread block per image.
//
// Replaces face_vijnana_yolov3_tpu/ops/pallas_nms.py::_sweep_kernel (and its
// pallas_call in nms_sweep_pallas): given boxes sorted by descending score,
// row i with score > 0 zeroes every later row j with IoU(i, j) >= iou_th,
// unless row i was zeroed itself first. NaN IoU (0/0 on degenerate pairs)
// never suppresses.
//
// What bounds it: not bytes (20 B a box) and not operations (one IoU per
// pair), but the chain of dependent steps. A sweep that walks the rows one
// by one, with a block barrier per row, takes N barriers (169 at a 13x13
// grid). This kernel splits the sweep in two:
//   1. mask: every warp of the block builds rows of the suppression bitmask
//      at once (32 warps), with no dependence between them. Bit j of mask[i][w] is set
//      iff j > i, j lies in word w (j = 32 w + lane) and IoU(i, j) >= th,
//      with box i as operand a of the JAX op order (ops/boxes.py:38-46).
//      One warp takes one (row, word) pair and forms the word with
//      __ballot_sync. Only rows with score > 0 can ever suppress, so only
//      they get a mask, and only words w >= i / 32 (the scan reads no other).
//   2. scan: one warp, with the `removed` bitset in registers (lane w holds
//      word w; 32 words cover kMaxN = 1024 rows). Word by word: the word's
//      32 diagonal mask words are shuffled to every lane, which resolves
//      the word's rows in the same unrolled register loop (a row is alive
//      iff its score > 0 and its bit is not removed; an alive row removes
//      the later rows of the word that its mask word marks), then one warp
//      OR-reduction per later word v (lane l holding row 32 w + l's word v)
//      folds the alive rows' masks into removed word v. There is no barrier
//      inside it.
// Then out[j] = removed(j) ? 0 : s[j], which is what the row-by-row sweep
// writes, for absent (score 0), negative and NaN rows too.
//
// Shared memory: boxes, scores and areas (24 B a row) and the mask,
// N x ceil(N/32) words, sized per launch (152 KB at N = 1024).
//
// Build flags (face_vijnana_yolov3_tpu_torch/kernels.py): -fmad=false and no
// --use_fast_math. That keeps IEEE division, keeps NaN >= th false, and
// keeps the area products out of fused multiply-adds, so each IoU is the
// JAX op order of ops/boxes.py:24-46, rounding for rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;  // the wrapper refuses larger N
constexpr unsigned kAll = 0xffffffffu;

// max(0, min(a_max, b_max) - max(a_min, b_min)) as jnp computes it, where
// minimum / maximum propagate NaN. The inner fminf / fmaxf drop a NaN
// coordinate instead, which cannot change a result: a NaN coordinate makes
// that box's area NaN, so the union and the IoU are NaN whatever the
// overlap is. The outer maximum keeps a NaN difference (inf - inf).
__device__ __forceinline__ float overlap(float a_min, float a_max,
                                         float b_min, float b_max) {
  const float d = fminf(a_max, b_max) - fmaxf(a_min, b_min);
  return d != d ? d : fmaxf(0.0f, d);
}

size_t smem_bytes(int n) {
  const int words = (n + 31) / 32;
  return static_cast<size_t>(n) * 6 * sizeof(float) +  // box, score, area
         static_cast<size_t>(n) * words * sizeof(uint32_t);
}

__global__ void __launch_bounds__(kThreads)
nms_sweep_kernel(const float* __restrict__ boxes,
                 const float* __restrict__ scores,
                 float* __restrict__ out, int n, float iou_th) {
  extern __shared__ float4 smem[];
  float4* box = smem;  // (xmin, ymin, xmax, ymax)
  float* s = reinterpret_cast<float*>(box + n);
  float* area = s + n;
  uint32_t* mask = reinterpret_cast<uint32_t*>(area + n);  // [n][words]
  const int words = (n + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float4 b = reinterpret_cast<const float4*>(boxes)[base + j];
    box[j] = b;
    s[j] = scores[base + j];
    area[j] = (b.z - b.x) * (b.w - b.y);  // area_a / area_b of ops/boxes.py
  }
  __syncthreads();

  // 1. mask: warp-wide tasks (i, w), i a row with score > 0, w >= i / 32;
  // warp k takes rows k, k + 16, ... (the branch is uniform across the warp).
  for (int i = warp; i < n; i += kWarps) {
    if (!(s[i] > 0.0f)) continue;
    const float4 a = box[i];
    const float area_a = area[i];
    for (int w = i >> 5; w < words; ++w) {
      const int j = 32 * w + lane;
      bool hit = false;
      if (j > i && j < n) {
        const float4 bj = box[j];
        const float iw = overlap(a.x, a.z, bj.x, bj.z);
        const float ih = overlap(a.y, a.w, bj.y, bj.w);
        const float intersect = iw * ih;
        const float uni = area_a + area[j] - intersect;
        hit = intersect / uni >= iou_th;  // NaN: false
      }
      const uint32_t bits = __ballot_sync(kAll, hit);
      if (lane == 0) mask[i * words + w] = bits;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 2. scan: lane v holds removed word v; no barrier below.
  uint32_t removed = 0u;
  for (int w = 0; w < words; ++w) {
    const int j = 32 * w + lane, rows = min(32, n - 32 * w);
    const uint32_t positive = __ballot_sync(kAll, j < n && s[j] > 0.0f);
    // Lane l holds row 32 w + l's mask words, loaded without a branch (a row
    // that is not positive has no mask; its word is loaded and never used).
    // The word's own rows resolve in a chain of register operations, the
    // diagonal words broadcast by shuffles that do not wait for the chain.
    const uint32_t* mrow = mask + (32 * w + min(lane, rows - 1)) * words;
    const uint32_t dl = mrow[w];
    uint32_t cand = positive & ~__shfl_sync(kAll, removed, w);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t d = __shfl_sync(kAll, dl, b);
      if ((cand >> b) & 1u) cand &= ~d;  // row b is alive
    }
    // Word v of `removed` takes the OR of the alive rows' words v, one warp
    // reduction a word.
    const bool alive = (cand >> lane) & 1u;
    for (int v = w; v < words; ++v) {
      const uint32_t mv = mrow[v];
      const uint32_t r = __reduce_or_sync(kAll, alive ? mv : 0u);
      if (lane == v) removed |= r;
    }
  }

  // 3. write.
  for (int w = 0; w < words; ++w) {
    const uint32_t r = __shfl_sync(kAll, removed, w);
    const int j = 32 * w + lane;
    if (j < n) out[base + j] = (r >> lane) & 1u ? 0.0f : s[j];
  }
}

}  // namespace

// boxes (B, N, 4), scores (B, N), out (B, N): contiguous f32 on one device,
// boxes 16-byte aligned. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int fvy_nms_sweep(const float* boxes, const float* scores,
                             float* out, int B, int N, float iou_th,
                             void* stream) {
  if (N < 0 || N > kMaxN || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const size_t smem = smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(
      nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_sweep_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, out, N, iou_th);
  return static_cast<int>(cudaGetLastError());
}
