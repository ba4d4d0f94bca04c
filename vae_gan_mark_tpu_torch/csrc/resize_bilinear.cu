// Bilinear resize of an NCHW float32 tensor (align_corners=False, no
// antialias) and its input gradient, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the resize to XLA
// (vae_gan_mark_tpu/ops/resize.py:interpolate_bilinear, jax.image.resize).
// It exists because PyTorch's NCHW kernel (upsample_bilinear2d_out_frame)
// gives one thread to each output pixel of a plane, at most out_h * out_w
// threads, and loops over all N * C planes in each: FiLM's text maps, 8,192
// planes of 1 x 28 resized to 1 x 448, get 448 threads for 3.7 M outputs.
// Its backward adds with float32 atomics, so float32 gradients change from
// run to run.
//
// What bounds it on an H100: bytes. An output costs two to six multiply-adds
// of input values that stay in L2; the forward writes N*C*out_h*out_w floats
// once (14.7 MB at the largest FiLM call, 4.4 us at 3.35 TB/s) and the
// backward reads that many once and writes the input's size. So every
// access to the large side is a full, coalesced line, and the grid comes
// from the large side's size, so that every shape fills the card.
//
// Design.
// - taps() maps an output index to its two source indices and weights with
//   PyTorch's own float32 arithmetic (area_pixel_compute_source_index):
//   scale = in / out, src = max(scale * (o + 0.5) - 0.5, 0), i0 = floor(src),
//   i1 = min(i0 + 1, in - 1), l1 = src - i0, l0 = 1 - l1. Forward and
//   backward both call it, so they agree at every edge (i1 == i0 at the
//   right one).
// - Forward: a warp per output row (n, c, oh), its lanes over ow in steps
//   of 32, so each store of a warp is 128 contiguous bytes in NCHW. The
//   row's height taps are computed once per thread. Input and output go
//   through their four strides: a transposed view needs no copy, and the
//   output takes the memory format PyTorch's resize gives that input
//   (channels-last for the serving engine's batch-1 text map), so the
//   convolutions after it see the layout they always saw. The taps combine
//   in PyTorch's order, l0h * (l0w * x00 + l1w * x01) + l1h * (l0w * x10 +
//   l1w * x11).
// - Backward: a gather, no atomics. A warp owns 32 input columns of one
//   input row (n, c, ih). For each output row whose height taps read ih, in
//   ascending order, it stages the output-gradient columns that its 32
//   columns' width taps read into shared memory with coalesced loads (at
//   most kChunk at a time); each lane then sums, in ascending ow, those
//   gradients weighted by its column's width-tap weight, and adds that sum
//   times the row's height-tap weight. The order is fixed, so float32
//   gradients repeat bit for bit. A height tap of weight 0 adds nothing and
//   its row is not read.
// - Both launch on the caller's stream, allocate nothing, synchronise
//   nothing and build no table, so a CUDA graph can capture them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                         // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;                       // staged columns a warp
constexpr int kChunkPadded = kChunk + kChunk / 32;   // one pad a 32 floats

struct Taps {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Taps taps(float scale, int o, int in) {
  float src = scale * (o + 0.5f) - 0.5f;
  src = src < 0.f ? 0.f : src;
  Taps t;
  t.i0 = static_cast<int>(src);
  t.i1 = t.i0 < in - 1 ? t.i0 + 1 : t.i0;
  t.l1 = src - t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

// The weight with which output o (taps t) reads input index i.
__device__ __forceinline__ float tap_weight(const Taps& t, int i) {
  return (t.i0 == i ? t.l0 : 0.f) + (t.i1 == i ? t.l1 : 0.f);
}

// The outputs whose taps may read input index i: src(o) in [i - 1, i + 1),
// widened by two on each side against rounding; tap_weight decides.
__device__ __forceinline__ int2 readers(int i, int in, int out) {
  const float r = static_cast<float>(out) / static_cast<float>(in);
  const int lo = static_cast<int>(floorf((i - 0.5f) * r - 0.5f)) - 2;
  const int hi = static_cast<int>(ceilf((i + 1.5f) * r - 0.5f)) + 2;
  return make_int2(max(lo, 0), min(hi, out - 1));
}

__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

__global__ void __launch_bounds__(kThreads) upsample_bilinear_fwd_kernel(
    const float* __restrict__ x, float* __restrict__ y, int64_t rows, int C,
    int in_h, int in_w, int out_h, int out_w, int64_t sn, int64_t sc,
    int64_t sh, int64_t sw, int64_t on, int64_t oc, int64_t oh_stride,
    int64_t ow_stride, float scale_h, float scale_w) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int oh = static_cast<int>(row % out_h);
  const int64_t nc = row / out_h;
  const Taps th = taps(scale_h, oh, in_h);
  const int64_t n = nc / C, c = nc % C;
  const float* r0 = x + n * sn + c * sc + th.i0 * sh;
  const float* r1 = x + n * sn + c * sc + th.i1 * sh;
  float* out = y + n * on + c * oc + oh * oh_stride;
  for (int ow = lane; ow < out_w; ow += 32) {
    const Taps tw = taps(scale_w, ow, in_w);
    const int64_t a = tw.i0 * sw, b = tw.i1 * sw;
    out[ow * ow_stride] =
        th.l0 * (tw.l0 * __ldg(r0 + a) + tw.l1 * __ldg(r0 + b)) +
        th.l1 * (tw.l0 * __ldg(r1 + a) + tw.l1 * __ldg(r1 + b));
  }
}

__global__ void __launch_bounds__(kThreads) upsample_bilinear_bwd_kernel(
    const float* __restrict__ dy, float* __restrict__ dx, int64_t tasks,
    int tiles, int in_h, int in_w, int out_h, int out_w, float scale_h,
    float scale_w) {
  __shared__ float stage[kWarps][kChunkPadded];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (task >= tasks) return;            // a whole warp; warps never meet
  const int64_t in_row = task / tiles;  // (n, c, ih)
  const int ih = static_cast<int>(in_row % in_h);
  const int iw_first = static_cast<int>(task % tiles) * 32;
  const int iw = iw_first + lane;
  const int iw_last = min(iw_first + 31, in_w - 1);
  const int cols_lo = readers(iw_first, in_w, out_w).x;
  const int cols_hi = readers(iw_last, in_w, out_w).y;
  const int2 mine = readers(min(iw, in_w - 1), in_w, out_w);
  const int2 rows = readers(ih, in_h, out_h);
  const float* plane = dy + (in_row / in_h) * out_h * out_w;
  float* s = stage[warp];
  float acc = 0.f;
  for (int oh = rows.x; oh <= rows.y; ++oh) {
    const float wh = tap_weight(taps(scale_h, oh, in_h), ih);
    if (wh == 0.f) continue;            // the same for the whole warp
    const float* g = plane + static_cast<int64_t>(oh) * out_w;
    float row_sum = 0.f;
    for (int c0 = cols_lo; c0 <= cols_hi; c0 += kChunk) {
      const int len = min(kChunk, cols_hi - c0 + 1);
      __syncwarp();
      for (int k = lane; k < len; k += 32) s[padded(k)] = g[c0 + k];
      __syncwarp();
      const int end = min(mine.y, c0 + len - 1);
      for (int ow = max(mine.x, c0); ow <= end; ++ow) {
        row_sum += tap_weight(taps(scale_w, ow, in_w), iw) *
                   s[padded(ow - c0)];
      }
    }
    acc += wh * row_sum;
  }
  if (iw < in_w) dx[in_row * in_w + iw] = acc;
}

bool bad_sizes(int N, int C, int in_h, int in_w, int out_h, int out_w) {
  return N <= 0 || C <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 ||
         out_w <= 0;
}

}  // namespace

// y (N, C, out_h, out_w) from x (N, C, in_h, in_w), each addressed through
// its element strides: x's (sn, sc, sh, sw), y's (on, oc, oh, ow).
extern "C" int upsample_bilinear_forward(const void* x, void* y, int N, int C,
                                         int in_h, int in_w, int out_h,
                                         int out_w, int64_t sn, int64_t sc,
                                         int64_t sh, int64_t sw, int64_t on,
                                         int64_t oc, int64_t oh, int64_t ow,
                                         cudaStream_t stream) {
  if (bad_sizes(N, C, in_h, in_w, out_h, out_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows = static_cast<int64_t>(N) * C * out_h;
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  upsample_bilinear_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows, C, in_h,
      in_w, out_h, out_w, sn, sc, sh, sw, on, oc, oh, ow,
      static_cast<float>(in_h) / static_cast<float>(out_h),
      static_cast<float>(in_w) / static_cast<float>(out_w));
  return static_cast<int>(cudaGetLastError());
}

// dx (N, C, in_h, in_w) from dy (N, C, out_h, out_w), both contiguous.
extern "C" int upsample_bilinear_backward(const void* dy, void* dx, int N,
                                          int C, int in_h, int in_w,
                                          int out_h, int out_w,
                                          cudaStream_t stream) {
  if (bad_sizes(N, C, in_h, in_w, out_h, out_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (in_w + 31) / 32;
  const int64_t tasks = static_cast<int64_t>(N) * C * in_h * tiles;
  const int64_t blocks = (tasks + kWarps - 1) / kWarps;
  upsample_bilinear_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      static_cast<const float*>(dy), static_cast<float*>(dx), tasks, tiles,
      in_h, in_w, out_h, out_w,
      static_cast<float>(in_h) / static_cast<float>(out_h),
      static_cast<float>(in_w) / static_cast<float>(out_w));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* upsample_bilinear_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
