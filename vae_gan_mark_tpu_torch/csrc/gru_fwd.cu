// GRU recurrence, forward, for Hopper (sm_90a): one direction or both
// directions of a bidirectional layer in one launch, one thread-block
// cluster of 8 CTAs per (direction, tile of 16 or 32 batch rows).
//
// Replaces vae_gan_mark_tpu/ops/pallas/gru.py:_gru_kernel (the pallas_call
// of _forward_impl, reached through pallas_gru_layer). Same function: from
// h0 = 0, for each step t
//   hp = h @ W_hh^T + b_hh
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h = (1 - z) * n + z * h,   out[t] = h
// with x_proj = x @ W_ih^T + b_ih precomputed, time-major (L, B, 3H), gate
// order (r, z, n), W_hh in torch's (3H, H) layout, all float32. ``reverse``
// walks t from L-1 down to 0 and writes out[t] in input order, which
// replaces the flip before and after the TPU kernel.
//
// What bounds it on an H100: not HBM and not FP32 throughput. The work is
// 2*L*B*H*3H flops per direction (0.38 GFLOP at L=60, B=16, H=256: about
// 6 us at the card's 67 TFLOP/s), but the L steps are strictly sequential,
// so the time is L times one step's latency: a (rows, H) x (H, 3H/8)
// product per CTA, the gate math, and the exchange of the new h between the
// SMs of a cluster.
//
// Design. CTA k of a cluster owns hidden units [k*H/8, (k+1)*H/8).
// - Directions: gridDim.y holds the directions (1 or 2), each with its own
//   tensors and walking order, so a BiGRU layer's forward is one launch and
//   its clusters run side by side.
// - Product: a group of 16 lanes owns 2 units, so 6 columns of the product
//   (r, z and n of each). Lane ks of a group keeps W_hh's values of those 6
//   columns at k = 16 i + ks (i < H/16) in registers for the whole launch,
//   96 of them at H=256. The product runs in passes of 8 batch rows: the
//   lane sums its k for 6 columns x 8 rows, then the group's 16 lanes
//   reduce-scatter the 48 sums with warp shuffles (rows, then units), which
//   leaves each lane r, z and n of one row of one unit. The gate math runs
//   there, and the lane keeps its rows' h in registers. No partial sum goes
//   through shared memory.
// - Shared-memory reads: h arrives k-major, one row of 16 (or 32) batch
//   values per k. Every lane reads its own k rows, and the two groups of a
//   warp walk their k blocks in different orders, so no two lanes of a warp
//   read the same word; the 16-byte quads of a row are rotated so that the
//   8 lanes of a quarter-warp read 8 different bank groups. Each h value
//   read feeds 6 FMAs.
// - Prefetch: the next step's x_proj for the lane's rows is loaded into
//   registers right after the gate math, a whole exchange and product ahead
//   of its use; it does not depend on the recurrence.
// - Exchange (cluster_exchange.cuh): each CTA writes its slice of the new h
//   (H/8 units x the tile's rows, 2 KB at H=256 and 16 rows) into its own
//   shared memory in the layout the receivers read, fences it, and 8
//   threads send it to the 8 CTAs (itself included), one cp.async.bulk
//   each, completing on the receiver's own mbarrier. A receiver waits on
//   that barrier only. Buffers are double-buffered; the cluster barrier,
//   split into arrive (after a step's product) and wait (one step later),
//   orders a buffer's reads before the next writes into it and costs no
//   wait: every peer has arrived by the time its next slice has landed.
// - Batch tiles: a cluster takes 16 batch rows, or 32 when 16-row tiles
//   would need more clusters than the card holds at once
//   (cudaOccupancyMaxActiveClusters; one CTA per SM at H=256), so both
//   directions at B=128 run in one wave of 8 clusters.
// FP32 FMAs throughout (no TF32), to match the TPU kernel's HIGHEST
// precision.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

using namespace cluster_exchange;

namespace {

constexpr int kCluster = 8;      // CTAs per cluster; each owns H/8 units
constexpr int kBlock = 16;       // batch rows per row block of a tile
constexpr int kPassRows = 8;     // batch rows per pass of the product
constexpr int kGroup = 16;       // lanes per group
constexpr int kUnits = 2;        // units per group
constexpr size_t kMaxSmem = 227 * 1024;

struct Direction {
  const float* xproj;    // (L, B, 3H)
  const float* whh;      // (3H, H)
  const float* bhh;      // (3H,)
  float* out;            // (L, B, H)
  int reverse;
};

struct Directions {
  Direction dir[2];
};

// NB: row blocks of 16 per tile (1 or 2).
template <int H, int NB>
struct Shape {
  static_assert(H % (kCluster * kUnits) == 0 && H % kGroup == 0, "H");
  static constexpr int U = H / kCluster;              // units per CTA
  static constexpr int kThreads = U / kUnits * kGroup;
  static constexpr int KL = H / kGroup;               // k rows per lane
  static constexpr int kRows = kBlock * NB;           // batch rows per tile
  static constexpr int kQuads = kRows / 4;            // quads per h row
  static constexpr int kPasses = kRows / kPassRows;
  static constexpr int kSlice = U * kRows;            // floats to each peer
  static constexpr size_t kSmem = sizeof(float) * (2 * H * kRows + 2 * kSlice);
  static constexpr unsigned kMask =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1;
};

// h row k (kRows floats) keeps its quad q in slot (q + k NB / 2) mod kQuads:
// the 8 consecutive rows that 8 neighbouring lanes read together then fall
// in 8 different 16-byte bank groups (rows are 64 or 128 bytes).
template <int NB>
__device__ __forceinline__ int quad_slot(int q, int k) {
  return (q + ((k * NB) >> 1)) & (4 * NB - 1);
}

// One round of a reduce-scatter across the lanes that differ in lane bit
// MASK: each keeps the half of its rows [0, 2 HALF) that the bit selects,
// moved to [0, HALF), plus the partner's copy of that half.
template <int HALF, int MASK>
__device__ __forceinline__ void halve_rows(
    float (&acc)[kUnits][3][kPassRows], int ks, unsigned sync_mask) {
  const bool hi = ks & MASK;
#pragma unroll
  for (int v = 0; v < kUnits; ++v) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int q = 0; q < HALF; ++q) {
        const float keep = hi ? acc[v][g][q + HALF] : acc[v][g][q];
        const float send = hi ? acc[v][g][q] : acc[v][g][q + HALF];
        acc[v][g][q] = keep + __shfl_xor_sync(sync_mask, send, MASK);
      }
    }
  }
}

// The last round, over the group's two units by lane bit 0, on the one row
// left: unit ks & 1 ends in acc[0].
__device__ __forceinline__ void halve_units(
    float (&acc)[kUnits][3][kPassRows], int ks, unsigned sync_mask) {
  const bool hi = ks & 1;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float keep = hi ? acc[1][g][0] : acc[0][g][0];
    const float send = hi ? acc[0][g][0] : acc[1][g][0];
    acc[0][g][0] = keep + __shfl_xor_sync(sync_mask, send, 1);
  }
}

// x_proj r/z/n of step s for the lane's row in each pass (batch rows
// b_first + 8 p); padded rows read zeros.
template <int H, int NB>
__device__ __forceinline__ void load_x(const Direction& d, int s, int L,
                                       int B, int b_first, int col,
                                       float (&x)[Shape<H, NB>::kPasses][3]) {
  const int t = d.reverse ? L - 1 - s : s;
#pragma unroll
  for (int p = 0; p < Shape<H, NB>::kPasses; ++p) {
    const int b = b_first + kPassRows * p;
    if (b < B) {
      const float* xp = d.xproj + (static_cast<size_t>(t) * B + b) * 3 * H
                        + col;
      x[p][0] = xp[0];
      x[p][1] = xp[H];
      x[p][2] = xp[2 * H];
    } else {
      x[p][0] = x[p][1] = x[p][2] = 0.f;
    }
  }
}

template <int H, int NB>
__global__ void __launch_bounds__(Shape<H, NB>::kThreads, 1)
gru_fwd_kernel(const __grid_constant__ Directions args, int L, int B) {
  using S = Shape<H, NB>;
  constexpr int U = S::U;
  constexpr int RF = S::kRows;                  // floats per h row
  const Direction& d = args.dir[blockIdx.y];
  const int rank = cluster_rank();
  const int b_tile = (blockIdx.x / kCluster) * S::kRows;
  const int unit0 = rank * U;
  const int tid = threadIdx.x;
  const int ks = tid % kGroup;
  const int group = tid / kGroup;
  const int u = group * kUnits + (ks & 1);      // the lane's unit (gate math)
  const int col = unit0 + u;                    // ... as a hidden index
  const int row = ks >> 1;                      // its row in each pass

  extern __shared__ __align__(16) float smem[];
  float* buf = smem;                            // [2][H][RF], quads rotated
  float* stage = buf + 2 * H * RF;              // [2][U][RF], quads rotated
  __shared__ __align__(8) uint64_t full_bar[2];

  if (tid == 0) {
    mbar_init(&full_bar[0]);
    mbar_init(&full_bar[1]);
    fence_mbar_init();
  }

  // Lane ks reads h rows k = 16 j + ks, j = i xor flip for i < KL: the odd
  // group of a warp starts half-way (flip = KL/2), so at any i the two
  // groups read different rows. It keeps W_hh[g H + unit][k] for its
  // group's two units in w[i][v][g].
  const int flip = (group & 1) * (S::KL / 2);
  float w[S::KL][kUnits][3];
#pragma unroll
  for (int i = 0; i < S::KL; ++i) {
    const int k = kGroup * (i ^ flip) + ks;
#pragma unroll
    for (int v = 0; v < kUnits; ++v) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        w[i][v][g] = d.whh[static_cast<size_t>(
                               g * H + unit0 + group * kUnits + v) * H + k];
      }
    }
  }
  float bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bias[g] = d.bhh[g * H + col];
  // The slots of rows 16 j + ks do not depend on j. Row i of the walk is
  // at lo + 16 RF i for i < KL/2 and hi + 16 RF i after (i xor flip is
  // i + flip, then i - flip).
  int quad_off[S::kQuads];
#pragma unroll
  for (int q = 0; q < S::kQuads; ++q) quad_off[q] = 4 * quad_slot<NB>(q, ks);
  const int lo = (ks + kGroup * flip) * RF;
  const int hi = (ks - kGroup * flip) * RF;

  float x[S::kPasses][3];
  load_x<H, NB>(d, 0, L, B, b_tile + row, col, x);
  float h[S::kPasses];
#pragma unroll
  for (int p = 0; p < S::kPasses; ++p) h[p] = 0.f;

  // Every CTA's barriers are initialised before any slice is sent.
  cluster_arrive();
  cluster_wait();

  const uint32_t slice_bytes = S::kSlice * sizeof(float);
  for (int s = 0; s < L; ++s) {
    const int t = d.reverse ? L - 1 - s : s;

    // hp = h_s @ W_hh^T + b_hh for the lane's rows; h_0 = 0.
    float hp[S::kPasses][3];
    if (s == 0) {
#pragma unroll
      for (int p = 0; p < S::kPasses; ++p) {
#pragma unroll
        for (int g = 0; g < 3; ++g) hp[p][g] = bias[g];
      }
    } else {
      const int rsel = (s - 1) & 1;
      mbar_wait(smem_u32(&full_bar[rsel]), ((s - 1) >> 1) & 1);
      __syncwarp(S::kMask);
      const float* rb = buf + rsel * H * RF;
#pragma unroll
      for (int p = 0; p < S::kPasses; ++p) {
        float acc[kUnits][3][kPassRows];
#pragma unroll
        for (int v = 0; v < kUnits; ++v) {
#pragma unroll
          for (int g = 0; g < 3; ++g) {
#pragma unroll
            for (int q = 0; q < kPassRows; ++q) acc[v][g][q] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < S::KL; ++i) {
          const float* hrow =
              rb + (2 * i < S::KL ? lo : hi) + kGroup * RF * i;
          const float4 a =
              *reinterpret_cast<const float4*>(hrow + quad_off[2 * p]);
          const float4 c =
              *reinterpret_cast<const float4*>(hrow + quad_off[2 * p + 1]);
#pragma unroll
          for (int v = 0; v < kUnits; ++v) {
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              const float wv = w[i][v][g];
              acc[v][g][0] = fmaf(a.x, wv, acc[v][g][0]);
              acc[v][g][1] = fmaf(a.y, wv, acc[v][g][1]);
              acc[v][g][2] = fmaf(a.z, wv, acc[v][g][2]);
              acc[v][g][3] = fmaf(a.w, wv, acc[v][g][3]);
              acc[v][g][4] = fmaf(c.x, wv, acc[v][g][4]);
              acc[v][g][5] = fmaf(c.y, wv, acc[v][g][5]);
              acc[v][g][6] = fmaf(c.z, wv, acc[v][g][6]);
              acc[v][g][7] = fmaf(c.w, wv, acc[v][g][7]);
            }
          }
        }
        // Rows 8 -> 4 -> 2 -> 1 by lane bits 3, 2, 1, then units by bit 0:
        // row ks >> 1 of unit ks & 1 is left in acc[0][g][0].
        halve_rows<4, 8>(acc, ks, S::kMask);
        halve_rows<2, 4>(acc, ks, S::kMask);
        halve_rows<1, 2>(acc, ks, S::kMask);
        halve_units(acc, ks, S::kMask);
#pragma unroll
        for (int g = 0; g < 3; ++g) hp[p][g] = acc[0][g][0] + bias[g];
      }
      // Step s's reads of rb are done; the wait is for the peers' arrival
      // at step s - 1, which every peer made before sending the slice that
      // just landed.
      if (s > 1) cluster_wait();
      cluster_arrive();
    }

    // Gate math for the lane's rows of unit col; the new h goes out and
    // into this step's slice.
    const int wsel = s & 1;
    float* st = stage + wsel * S::kSlice;
#pragma unroll
    for (int p = 0; p < S::kPasses; ++p) {
      const float r = sigmoidf(x[p][0] + hp[p][0]);
      const float z = sigmoidf(x[p][1] + hp[p][1]);
      const float n = tanhf(x[p][2] + r * hp[p][2]);
      h[p] = (1.f - z) * n + z * h[p];
      const int tr = kPassRows * p + row;       // row in the tile
      if (b_tile + tr < B) {
        d.out[(static_cast<size_t>(t) * B + b_tile + tr) * H + col] = h[p];
      }
      st[u * RF + 4 * quad_slot<NB>(tr >> 2, col) + (tr & 3)] = h[p];
    }
    if (s + 1 == L) break;
    // The next step's x_proj is in flight during the exchange and product.
    load_x<H, NB>(d, s + 1, L, B, b_tile + row, col, x);

    fence_proxy_async();
    __syncthreads();
    const uint32_t bar = smem_u32(&full_bar[wsel]);
    if (tid == 0) mbar_expect_tx(bar, kCluster * slice_bytes);
    if (tid < kCluster) {                       // thread k sends to CTA k
      send_to_peer(smem_u32(buf + wsel * H * RF + rank * S::kSlice),
                   smem_u32(st), slice_bytes, bar, tid);
    }
  }
  // No CTA leaves while a peer may still read from or write into its
  // shared memory.
  if (L > 1) cluster_wait();
}

template <int H, int NB>
cudaLaunchConfig_t launch_config(int ndir, int B, cudaLaunchAttribute* attr) {
  using S = Shape<H, NB>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + S::kRows - 1) / S::kRows) * kCluster, ndir, 1);
  cfg.blockDim = dim3(S::kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per process and kernel: the shared-memory attribute.
template <int H, int NB>
cudaError_t set_smem_once() {
  static bool done = false;
  if (!done) {
    static_assert(Shape<H, NB>::kSmem <= kMaxSmem, "shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        gru_fwd_kernel<H, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Shape<H, NB>::kSmem));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

template <int H, int NB>
cudaError_t max_clusters(int* count) {
  cudaError_t err = set_smem_once<H, NB>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config<H, NB>(1, kBlock * NB, attr);
  return cudaOccupancyMaxActiveClusters(count, gru_fwd_kernel<H, NB>, &cfg);
}

// Row blocks per tile: 1 (16 rows) unless 16-row tiles would need more
// clusters than the card holds at once; then 2 (32 rows).
template <int H>
cudaError_t row_blocks(int ndir, int B, int* nb) {
  static int fit = 0;
  if (fit == 0) {
    cudaError_t err = max_clusters<H, 1>(&fit);
    if (err != cudaSuccess) return err;
  }
  *nb = ndir * ((B + kBlock - 1) / kBlock) <= fit ? 1 : 2;
  return cudaSuccess;
}

template <int H, int NB>
cudaError_t launch_tiles(const Directions& args, int ndir, int L, int B,
                         cudaStream_t stream) {
  cudaError_t err = set_smem_once<H, NB>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config<H, NB>(ndir, B, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, gru_fwd_kernel<H, NB>, args, L, B);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(const Directions& args, int ndir, int L, int B,
                   cudaStream_t stream) {
  int nb = 1;
  cudaError_t err = row_blocks<H>(ndir, B, &nb);
  if (err != cudaSuccess) return err;
  return nb == 1 ? launch_tiles<H, 1>(args, ndir, L, B, stream)
                 : launch_tiles<H, 2>(args, ndir, L, B, stream);
}

template <int H>
cudaError_t tile_rows(int ndir, int B, int* rows) {
  int nb = 1;
  cudaError_t err = row_blocks<H>(ndir, B, &nb);
  *rows = kBlock * nb;
  return err;
}

template <int H>
cudaError_t max_clusters_at(int rows, int* count) {
  if (rows == kBlock) return max_clusters<H, 1>(count);
  if (rows == 2 * kBlock) return max_clusters<H, 2>(count);
  return cudaErrorInvalidValue;
}

}  // namespace

// ptrs: 4 device pointers per direction, in the order x_proj, W_hh, b_hh,
// out (shapes as in Direction); reverse: one flag per direction; ndir is 1
// or 2. H must be one of 16, 32, 64, 128, 256. Returns a cudaError_t.
extern "C" int gru_forward(void* const* ptrs, const int* reverse, int ndir,
                           int L, int B, int H, cudaStream_t stream) {
  if (L <= 0 || B <= 0 || ndir < 1 || ndir > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Directions args = {};
  for (int k = 0; k < ndir; ++k) {
    void* const* p = ptrs + 4 * k;
    args.dir[k] = Direction{static_cast<const float*>(p[0]),
                            static_cast<const float*>(p[1]),
                            static_cast<const float*>(p[2]),
                            static_cast<float*>(p[3]), reverse[k]};
  }
  cudaError_t err;
  switch (H) {
    case 16: err = launch<16>(args, ndir, L, B, stream); break;
    case 32: err = launch<32>(args, ndir, L, B, stream); break;
    case 64: err = launch<64>(args, ndir, L, B, stream); break;
    case 128: err = launch<128>(args, ndir, L, B, stream); break;
    case 256: err = launch<256>(args, ndir, L, B, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The batch rows per cluster that a launch of ndir directions at batch B
// takes (16 or 32).
extern "C" int gru_forward_tile_rows(int ndir, int B, int H, int* rows) {
  if (B <= 0 || ndir < 1 || ndir > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (H) {
    case 16: err = tile_rows<16>(ndir, B, rows); break;
    case 32: err = tile_rows<32>(ndir, B, rows); break;
    case 64: err = tile_rows<64>(ndir, B, rows); break;
    case 128: err = tile_rows<128>(ndir, B, rows); break;
    case 256: err = tile_rows<256>(ndir, B, rows); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// cudaOccupancyMaxActiveClusters of the kernel at hidden size H and tile
// rows 16 or 32: how many clusters of 8 CTAs the card holds at once.
extern "C" int gru_forward_max_clusters(int H, int rows, int* count) {
  cudaError_t err;
  switch (H) {
    case 16: err = max_clusters_at<16>(rows, count); break;
    case 32: err = max_clusters_at<32>(rows, count); break;
    case 64: err = max_clusters_at<64>(rows, count); break;
    case 128: err = max_clusters_at<128>(rows, count); break;
    case 256: err = max_clusters_at<256>(rows, count); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* gru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
