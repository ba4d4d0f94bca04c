// SAME, stride-1 3x3 convolution, NHWC, bf16 in and out, f32 accumulation,
// for Hopper (sm_90a): a tensor-core implicit GEMM.
//
// Replaces benchmarks/pallas_conv_probe.py:conv3x3_superp (its Pallas body
// _superp_kernel). It computes the probe's function,
//   y[n, h, w, co] = sum_{dy, dx, ci} x[n, h+dy-1, w+dx-1, ci] k[dy, dx, ci, co]
// with zero padding, not the probe's schedule: the width fold f and the
// strip-wise im2col exist to fill the TPU's 128 lanes and leave the result
// unchanged, so they have no counterpart here (the wrapper still checks the
// probe's shape rules). The wrapper hands the kernel k as [dy][dx][co][ci]
// (each tap a K-major C x C matrix, the layout wgmma's B operand reads).
//
// What bounds it on an H100: at the probe's shapes, bf16 tensor-core
// operations and HBM bytes about equally (0.27 ms and 0.28 ms at
// (128, 64, 448, 64)), so the products must run on the tensor cores and the
// copies must overlap them.
//
// Design: an implicit GEMM, M = output pixels, N = C_out, K = 9 * C_in,
// walked as 9 taps x C/16 k-steps of wgmma m64nCk16 (bf16 in, f32 sums).
// - Persistent CTAs, one per SM, walk the (n, 4-row, 64-column) output tiles
//   round-robin. Four consumer warpgroups each own one 64-pixel row of the
//   tile (one m64 wgmma tile); one producer warp issues the copies.
// - The whole weight tensor (9*C*C bf16, 72 KB at C=64) is loaded once per
//   CTA by TMA into shared memory, swizzled as wgmma's B operand reads it.
// - Input halo tiles (C, 66, 6, 1) arrive by TMA from a 4-D tensor map over
//   (C, W, H, N) at (0, x0-1, y0-1, n) into a 2-stage ring guarded by
//   mbarriers (full: bytes landed; empty: the 16 consumer warps are done).
//   TMA fills out-of-bounds elements with zeros, which is the SAME padding
//   and the ragged right and bottom edges. A pixel is C*2 bytes, so the
//   tiles use the 128-byte swizzle at C=64 and the 64-byte one at C=32.
// - Tap (dy, dx) reads the halo tile shifted by dx pixels, which breaks a
//   shared-memory descriptor's alignment to the swizzle pattern, so A comes
//   from registers: ldmatrix with per-lane row addresses that apply the
//   same XOR swizzle as TMA. B (the tap's weights) comes from shared memory
//   through a descriptor. A is double-buffered in registers across taps.
// - Epilogue: each warp converts its 16 x C f32 sums to bf16, stages them
//   in a swizzled shared tile and writes them with 16-byte stores behind the
//   edge mask. The producer has the next tile's halo in flight meanwhile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 4;                    // output rows per tile
constexpr int kTW = 64;                   // output columns per tile (m64)
constexpr int kHaloH = kTH + 2;
constexpr int kHaloW = kTW + 2;
constexpr int kConsumerWarps = kTH * 4;   // one warpgroup per output row
constexpr int kThreads = kConsumerWarps * 32 + 32;   // + the producer warp
constexpr int kStages = 2;
constexpr size_t kMaxSmem = 227 * 1024;

template <int C>
struct Cfg {
  static constexpr int kPitch = C * 2;                  // bytes per pixel
  static constexpr uint32_t kSwizzleMask = kPitch / 16 - 1;   // 7 or 3
  static constexpr int kKSteps = C / 16;
  static constexpr int kTapBytes = C * C * 2;
  static constexpr int kWeightBytes = 9 * kTapBytes;
  static constexpr int kHaloBytes = kHaloH * kHaloW * kPitch;
  static constexpr int kStageBytes = (kHaloBytes + 1023) / 1024 * 1024;
  static constexpr int kStagingBytes = kConsumerWarps * 16 * kPitch;
  // 1 KB of slack to align the swizzled buffers to 1024 bytes.
  static constexpr int kSmemBytes =
      1024 + kWeightBytes + kStages * kStageBytes + kStagingBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The swizzle TMA applies (128B: bits [4,7) ^= bits [7,10); 64B: bits
// [4,6) ^= bits [7,9)), on a shared-memory address.
template <int C>
__device__ __forceinline__ uint32_t swz(uint32_t addr) {
  return addr ^ (((addr >> 7) & Cfg<C>::kSwizzleMask) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// B descriptor: K-major, swizzled rows of C bf16, 8-row groups 8*pitch
// apart (LBO is unused for swizzled K-major layouts).
template <int C>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;
  d |= uint64_t((8 * Cfg<C>::kPitch) >> 4) << 32;
  d |= uint64_t(C == 64 ? 1 : 2) << 62;     // 128B or 64B swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int C>
__device__ __forceinline__ void fence_acc(float (&d)[C / 2]) {
#pragma unroll
  for (int i = 0; i < C / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x C, f32) += A (64 x 16, bf16 registers) * B (16 x C, bf16 smem).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               __nv_bfloat16* __restrict__ y, int N, int H, int W) {
  using K = Cfg<C>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t w_bar;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t w_s = (raw + 1023) & ~1023u;       // [9][C_out][C_in]
  const uint32_t x_s = w_s + K::kWeightBytes;       // [kStages] halo tiles
  const uint32_t st_s = x_s + kStages * K::kStageBytes;   // [16 warps][16][C]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const int n_tiles = N * tiles_h * tiles_w;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumerWarps);
    }
    mbar_init(smem_u32(&w_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // Producer: the weights once, then one halo tile per output tile.
    if (lane == 0) {
      mbar_expect_tx(smem_u32(&w_bar), K::kWeightBytes);
      for (int tap = 0; tap < 9; ++tap) {
        tma_load_2d(w_s + tap * K::kTapBytes, &w_map, smem_u32(&w_bar), 0,
                    tap * C);
      }
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const int s = i % kStages;
        if (i >= kStages) {
          mbar_wait(smem_u32(&empty_bar[s]), ((i / kStages) - 1) & 1);
        }
        const int tw = tile % tiles_w;
        const int rest = tile / tiles_w;
        const int th = rest % tiles_h;
        const int n = rest / tiles_h;
        mbar_expect_tx(smem_u32(&full_bar[s]), K::kHaloBytes);
        tma_load_4d(x_s + s * K::kStageBytes, &x_map, smem_u32(&full_bar[s]),
                    0, tw * kTW - 1, th * kTH - 1, n);
      }
    }
    return;
  }

  // Consumers. Warpgroup wg computes output row y0 + wg; its warp wq holds
  // pixels [16 wq, 16 wq + 16) of that row. For ldmatrix.x4, lane l gives
  // the address of row l % 8 of matrix l / 8: matrices 0/1 are A rows 0-7 /
  // 8-15 at k 0-7, matrices 2/3 the same rows at k 8-15.
  const int wg = warp / 4;
  const int wq = warp % 4;
  const int a_row = wq * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_khalf = lane >> 4;
  const uint32_t staging = st_s + warp * 16 * K::kPitch;

  mbar_wait(smem_u32(&w_bar), 0);
  __syncwarp();
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int s = i % kStages;
    const int tw = tile % tiles_w;
    const int rest = tile / tiles_w;
    const int th = rest % tiles_h;
    const int n = rest / tiles_h;
    const uint32_t xs = x_s + s * K::kStageBytes;

    float acc[C / 2];
#pragma unroll
    for (int j = 0; j < C / 2; ++j) acc[j] = 0.f;
    fence_acc<C>(acc);

    mbar_wait(smem_u32(&full_bar[s]), (i / kStages) & 1);
    __syncwarp();     // the warpgroup's wgmma and ldmatrix are .aligned

    uint32_t a[2][K::kKSteps][4];
    auto load_a = [&](int tap, uint32_t (&dst)[K::kKSteps][4]) {
      const int dy = tap / 3, dx = tap % 3;
      const uint32_t pix =
          xs + ((wg + dy) * kHaloW + a_row + dx) * K::kPitch + a_khalf * 16;
#pragma unroll
      for (int ks = 0; ks < K::kKSteps; ++ks) {
        ldmatrix_x4(dst[ks], swz<C>(pix + ks * 32));
      }
    };
    load_a(0, a[0]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < K::kKSteps; ++ks) {
        wgmma_rs(acc, a[tap & 1][ks],
                 b_desc<C>(w_s + tap * K::kTapBytes + ks * 32));
      }
      wgmma_commit();
      if (tap + 1 < 9) {
        // The group of tap - 1 read a[(tap + 1) & 1]; it is done after this.
        wgmma_wait<1>();
        load_a(tap + 1, a[(tap + 1) & 1]);
      }
    }
    wgmma_wait<0>();
    fence_acc<C>(acc);
    // Every ldmatrix of this warp has returned: the stage may be refilled.
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));

    // Epilogue: rows lane/4 and lane/4 + 8 of this warp's 16, columns
    // 8j + 2(lane%4) + {0, 1}, through the swizzled staging tile.
    const int r = lane >> 2;
    const int c2 = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      const uint32_t col = (8 * j + c2) * 2;
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(swz<C>(
                       staging + r * K::kPitch + col)),
                   "r"(*reinterpret_cast<const uint32_t*>(&lo)) : "memory");
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(swz<C>(
                       staging + (r + 8) * K::kPitch + col)),
                   "r"(*reinterpret_cast<const uint32_t*>(&hi)) : "memory");
    }
    __syncwarp();
    const int gy = th * kTH + wg;
    constexpr int kChunks = 16 * C / 8;          // 16-byte chunks per warp
#pragma unroll
    for (int it = 0; it < kChunks / 32; ++it) {
      const int idx = it * 32 + lane;
      const int pr = idx / (C / 8);
      const int ch = idx % (C / 8);
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(swz<C>(staging + pr * K::kPitch + ch * 16)));
      const int gx = tw * kTW + wq * 16 + pr;
      if (gx < W && gy < H) {
        *reinterpret_cast<uint4*>(
            y + ((static_cast<size_t>(n) * H + gy) * W + gx) * C + ch * 8) = v;
      }
    }
    // The staging reads are done before the next tile's writes.
    __syncwarp();
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Process-wide, set up at the first launch: the driver's tensor-map encoder
// (reached through the runtime, so the library needs no -lcuda), the SM
// count, and the kernels' shared-memory attribute.
struct Setup {
  EncodeTiledFn encode = nullptr;
  int sms = 0;
  bool smem_set[2] = {false, false};
};
Setup g_setup;

cudaError_t setup_once() {
  if (g_setup.encode != nullptr) return cudaSuccess;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &status);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &status);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaDriverEntryPointSuccess || fn == nullptr) {
    return cudaErrorSymbolNotFound;
  }
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&g_setup.sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  g_setup.encode = reinterpret_cast<EncodeTiledFn>(fn);
  return cudaSuccess;
}

template <int C>
cudaError_t launch(const void* x, const void* k, void* y, int N, int H, int W,
                   cudaStream_t stream) {
  using K = Cfg<C>;
  static_assert(K::kSmemBytes <= kMaxSmem, "shared memory");
  const CUtensorMapSwizzle swizzle =
      C == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)N};
  const cuuint64_t x_strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                   (cuuint64_t)H * W * C * 2};
  const cuuint32_t x_box[4] = {C, kHaloW, kHaloH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = g_setup.encode(
      &x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
      x_dims, x_strides, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t w_dims[2] = {(cuuint64_t)C, (cuuint64_t)9 * C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t w_box[2] = {C, C};
  res = g_setup.encode(
      &w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(k),
      w_dims, w_strides, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;

  bool& smem_set = g_setup.smem_set[C == 64 ? 1 : 0];
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K::kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long n_tiles = (long long)N * ((H + kTH - 1) / kTH) *
                            ((W + kTW - 1) / kTW);
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      n_tiles < g_setup.sms ? n_tiles : g_setup.sms);
  conv3x3_kernel<C><<<grid, kThreads, K::kSmemBytes, stream>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(y), N, H, W);
  return cudaGetLastError();
}

}  // namespace

// x (N, H, W, C) and y bf16 NHWC; k bf16 [3][3][C_out][C_in]; C in {32, 64};
// x and k 16-byte aligned. Returns a cudaError_t: cudaErrorInvalidValue for
// shapes the kernel does not take.
extern "C" int conv3x3_forward(const void* x, const void* k, void* y, int N,
                               int H, int W, int C, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || (C != 32 && C != 64) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = setup_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = C == 64 ? launch<64>(x, k, y, N, H, W, stream)
                : launch<32>(x, k, y, N, H, W, stream);
  return static_cast<int>(err);
}

extern "C" const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
