// SAME, stride-1 3x3 convolution, NHWC, bf16 in and out, f32 accumulation,
// for Hopper (sm_90a).
//
// Replaces benchmarks/pallas_conv_probe.py:conv3x3_superp (its Pallas body
// _superp_kernel). It computes the probe's function,
//   y[n, h, w, co] = sum_{dy, dx, ci} x[n, h+dy-1, w+dx-1, ci] k[dy, dx, ci, co]
// with zero padding, not the probe's schedule: the width fold f and the
// strip-wise im2col exist to fill the TPU's 128 lanes and leave the result
// unchanged, so they have no counterpart here (the wrapper still checks the
// probe's shape rules).
//
// What bounds it on an H100: at the probe's shapes, tensor-core operations
// and HBM bytes about equally (0.27 ms and 0.28 ms at (128, 64, 448, 64)).
// This kernel uses the CUDA cores, so its own ceiling is the 67 TFLOP/s of
// FP32 FMA, some 15x under the tensor cores: a first, simple kernel.
//
// Design: persistent blocks, one per SM slot, walk the (n, 8-row, 16-column)
// output tiles. A block loads the whole kernel (9*C*C bf16, 72 KB at C=64)
// into shared memory once, then for each tile the input tile with its
// 1-pixel halo, channel-major so that a warp's reads of neighbouring columns
// fall in distinct banks. Each thread owns 4 neighbouring pixels of a row
// and 8 output channels: per (dy, ci) it reads 6 inputs and 3 vectors of 8
// weights and does 96 FMAs into 32 f32 accumulators, then writes its 4 x 8
// outputs as 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8;        // output rows per tile
constexpr int kTW = 16;       // output columns per tile
constexpr int kPix = 4;       // neighbouring pixels per thread
constexpr int kCo = 8;        // output channels per thread
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 227 * 1024;

size_t smem_bytes(int c) {
  return sizeof(__nv_bfloat16) *
         ((size_t)9 * c * c + (size_t)c * (kTH + 2) * (kTW + 2));
}

__global__ void __launch_bounds__(kMaxThreads)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ k,
               __nv_bfloat16* __restrict__ y, int N, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // HWIO
  __nv_bfloat16* x_s = w_s + 9 * C * C;       // [C][kTH + 2][kTW + 2]
  const int tid = threadIdx.x;
  const int threads = blockDim.x;

  {
    const int chunks = 9 * C * C / 8;         // 16-byte chunks (C % 8 == 0)
    const int4* src = reinterpret_cast<const int4*>(k);
    int4* dst = reinterpret_cast<int4*>(w_s);
    for (int i = tid; i < chunks; i += threads) dst[i] = src[i];
  }

  const int co_groups = C / kCo;
  const int cg = tid % co_groups;             // output channels cg*8 ..
  const int pg = tid / co_groups;             // pixel group of the tile
  const int py = pg / (kTW / kPix);
  const int px = (pg % (kTW / kPix)) * kPix;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const long long n_tiles = (long long)N * tiles_h * tiles_w;
  constexpr int kRow = kTW + 2;
  constexpr int kPlane = (kTH + 2) * kRow;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tw = static_cast<int>(tile % tiles_w);
    const long long rest = tile / tiles_w;
    const int th = static_cast<int>(rest % tiles_h);
    const int n = static_cast<int>(rest / tiles_h);
    const int y0 = th * kTH, x0 = tw * kTW;

    // The previous tile's reads of x_s (and, first time, the weight copy)
    // are done before x_s is overwritten.
    __syncthreads();
    for (int i = tid; i < kPlane * C; i += threads) {
      const int ci = i % C;
      const int p = i / C;
      const int r = p / kRow, c = p - r * kRow;
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = x[(((size_t)n * H + gy) * W + gx) * C + ci];
      }
      x_s[ci * kPlane + p] = v;
    }
    __syncthreads();

    float acc[kPix][kCo];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
#pragma unroll
      for (int o = 0; o < kCo; ++o) acc[p][o] = 0.f;
    }
    for (int dy = 0; dy < 3; ++dy) {
      for (int ci = 0; ci < C; ++ci) {
        const __nv_bfloat16* xr = x_s + ci * kPlane + (py + dy) * kRow + px;
        float xv[kPix + 2];
#pragma unroll
        for (int q = 0; q < kPix + 2; ++q) xv[q] = __bfloat162float(xr[q]);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int4 raw = *reinterpret_cast<const int4*>(
              w_s + ((dy * 3 + dx) * C + ci) * C + cg * kCo);
          const __nv_bfloat162* w2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          float wv[kCo];
#pragma unroll
          for (int q = 0; q < kCo / 2; ++q) {
            const float2 f = __bfloat1622float2(w2[q]);
            wv[2 * q] = f.x;
            wv[2 * q + 1] = f.y;
          }
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
#pragma unroll
            for (int o = 0; o < kCo; ++o) {
              acc[p][o] = fmaf(xv[p + dx], wv[o], acc[p][o]);
            }
          }
        }
      }
    }

    const int gy = y0 + py;
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int gx = x0 + px + p;
      if (gy < H && gx < W) {
        int4 packed;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int q = 0; q < kCo / 2; ++q) {
          o2[q] = __floats2bfloat162_rn(acc[p][2 * q], acc[p][2 * q + 1]);
        }
        *reinterpret_cast<int4*>(
            y + (((size_t)n * H + gy) * W + gx) * C + cg * kCo) = packed;
      }
    }
  }
}

}  // namespace

extern "C" int conv3x3_forward(const __nv_bfloat16* x, const __nv_bfloat16* k,
                               __nv_bfloat16* y, int N, int H, int W, int C,
                               cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % kCo != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (kTH * kTW / kPix) * (C / kCo);
  const size_t smem = smem_bytes(C);
  if (threads > kMaxThreads || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long n_tiles = (long long)N * ((H + kTH - 1) / kTH) *
                            ((W + kTW - 1) / kTW);
  const long long slots = (long long)sms * per_sm;
  const int grid = static_cast<int>(n_tiles < slots ? n_tiles : slots);
  conv3x3_kernel<<<grid, threads, smem, stream>>>(x, k, y, N, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
