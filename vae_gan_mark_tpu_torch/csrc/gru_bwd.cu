// GRU recurrence, backward, for Hopper (sm_90a): both directions of a
// bidirectional layer in one launch, one thread-block cluster of 8 CTAs per
// (direction, tile of 16 batch rows).
//
// Replaces the backward of vae_gan_mark_tpu/ops/pallas/gru.py:pallas_gru_layer
// (its custom_vjp rule _bwd, a reverse lax.scan). For each step t, walked
// against the forward's order, with dh = dh_next + grad[t] and h_prev the
// forward's previous output (outs[t-1], or outs[t+1] when reverse; zeros at
// its first step):
//   r, z, n from x_proj[t] and hp = h_prev @ W_hh^T + b_hh
//   dn_pre = dh (1 - z)(1 - n^2),  dz_pre = dh (h_prev - n) z (1 - z)
//   dr_pre = dn_pre hn r (1 - r)
//   dx_proj[t] = [dr_pre, dz_pre, dn_pre],  dhp[t] = [dr_pre, dz_pre, dn_pre r]
//   dh_next = dh z + dhp[t] @ W_hh
// with W_hh in torch's (3H, H) layout, gate order (r, z, n), all float32.
// The wrapper (ops/gru.py) computes hp_outs = outs @ W_hh^T + b_hh for every
// step before the kernel (every h_prev is a saved output) and forms
// dW_hh = dhp^T @ h_prev and db_hh = sum(dhp) after it.
//
// What bounds it on an H100: the L steps are strictly sequential, so the
// time is L times one step's latency: a (16, 3H) x (3H, H/8) product per
// CTA, the gate math, and the exchange of dhp between the SMs of a cluster.
// The work is 2*L*B*3H*H flops per direction (0.38 GFLOP at L=60, B=16,
// H=256), microseconds at the card's FP32 rate.
//
// Design. CTA k of a cluster owns hidden units [k*H/8, (k+1)*H/8).
// - Directions: gridDim.y holds the directions (1 or 2), each with its own
//   tensors and walking order, so a BiGRU layer's backward is one launch
//   and its clusters run side by side.
// - Threads: a group of KS = 8 UT lanes owns UT units (UT = 4, or H/8
//   when that is smaller); 8 lanes per unit in all. For the product, lane
//   ks of a group sums exchange rows j = KS i + ks for all UT units and 16
//   rows, with its W_hh values (3H/8 of them) in registers for the whole
//   launch. For the gate math it owns batch rows 2 (ks / UT) and
//   2 (ks / UT) + 1 of unit ks % UT of its group.
// - Prefetch: the inputs of step s+1 (x_proj, hp, h_prev and the cotangent
//   for the lane's rows) are loaded into registers right after step s's
//   gate math, a whole exchange and product ahead of their use; none of
//   them depends on the recurrence.
// - Exchange (cluster_exchange.cuh): each CTA writes its dhp slice (3
//   gates x H/8 units x 16 rows, 6 KB at H=256) into its own shared
//   memory in the layout the receivers read; 8 threads then send it to
//   the 8 CTAs (itself included), one bulk copy each (cp.async.bulk
//   shared::cta -> shared::cluster),
//   completing on the receiver's own mbarrier. A receiver waits on that
//   barrier only, not on the whole cluster. Buffers are double-buffered;
//   the cluster barrier, split into arrive (after a step's product) and
//   wait (one step later), orders a buffer's reads before the next writes
//   into it and costs no wait: every peer has arrived by the time its next
//   slice has landed.
// - Product: the shared-memory reads bound it, so every lane of a warp
//   reads a distinct exchange row (no lane repeats another's read) and
//   uses each value for UT units; rows rotate their 16-byte quads so that
//   8 lanes of a read hit 8 different bank groups. The KS lanes of a group
//   then reduce-scatter their UT x 16 partial sums with warp shuffles
//   (rows first, then units), which leaves each lane the dh_next of
//   exactly its own two rows. dh never leaves registers.
// - Occupancy: at H=256 a CTA of 256 threads takes over 128 registers a
//   thread (W_hh's columns and the 64 partial sums), so one CTA per SM; an
//   H100 then holds 15 clusters of 8 (cudaOccupancyMaxActiveClusters) and
//   both directions at B=128 (16 clusters) run in two waves.
// FP32 FMAs throughout (no TF32), to match the TPU kernel's HIGHEST
// precision.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

using namespace cluster_exchange;

namespace {

constexpr int kCluster = 8;      // CTAs per cluster; each owns H/8 units
constexpr int kTile = 16;        // batch rows per cluster
constexpr int kLanesPerUnit = 8;
constexpr int kRows = kTile / kLanesPerUnit;   // batch rows per lane (2)
constexpr int kInputs = 8 * kRows;             // prefetched floats per lane
constexpr size_t kMaxSmem = 227 * 1024;

struct Direction {
  const float* xproj;    // (L, B, 3H)
  const float* hp_outs;  // (L, B, 3H): outs @ W_hh^T + b_hh
  const float* outs;     // (L, B, H)
  const float* grad;     // (L, B, H)
  const float* whh;      // (3H, H)
  const float* bhh;      // (3H,)
  float* dxp;            // (L, B, 3H)
  float* dhp;            // (L, B, 3H)
  int reverse;
};

struct Directions {
  Direction dir[2];
};

template <int H>
struct Shape {
  static constexpr int U = H / kCluster;          // units per CTA
  static constexpr int J = 3 * H;                 // exchange rows
  static constexpr int UT = U < 4 ? U : 4;        // units per lane group
  static constexpr int KS = kLanesPerUnit * UT;   // lanes per group
  static constexpr int kThreads = U * kLanesPerUnit;
  static constexpr int kRowsPerLane = J / KS;     // exchange rows, = 3U / UT
  static constexpr int kSlice = 3 * U * kTile;    // floats sent to each peer
  static constexpr size_t kSmem = sizeof(float) * (2 * J * kTile + 2 * kSlice);
  static constexpr unsigned kMask =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1;
};

// Exchange row j (16 floats, 64 bytes) keeps its quad q (rows 4q .. 4q+3)
// in slot (q + j/2) % 4: the 8 consecutive rows that 8 neighbouring lanes
// read together then fall in 8 different 16-byte bank groups.
__device__ __forceinline__ int quad_slot(int q, int j) {
  return (q + (j >> 1)) & 3;
}

// One round of a reduce-scatter across lanes that differ in lane bit MASK:
// each keeps the half of its rows [0, 2 HALF) that the bit selects, moved
// to [0, HALF), plus the partner's copy of that half.
template <int HALF, int MASK, int UT>
__device__ __forceinline__ void halve_rows(float (&acc)[UT][kTile], int ks,
                                           unsigned sync_mask) {
  const bool hi = ks & MASK;
#pragma unroll
  for (int v = 0; v < UT; ++v) {
#pragma unroll
    for (int q = 0; q < HALF; ++q) {
      const float keep = hi ? acc[v][q + HALF] : acc[v][q];
      const float send = hi ? acc[v][q] : acc[v][q + HALF];
      acc[v][q] = keep + __shfl_xor_sync(sync_mask, send, MASK);
    }
  }
}

// The same over units [0, 2 HALF), by lane bit HALF, on the kRows rows left.
template <int HALF, int UT>
__device__ __forceinline__ void halve_units(float (&acc)[UT][kTile], int ks,
                                            unsigned sync_mask) {
  const bool hi = ks & HALF;
#pragma unroll
  for (int v = 0; v < HALF; ++v) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float keep = hi ? acc[v + HALF][q] : acc[v][q];
      const float send = hi ? acc[v][q] : acc[v + HALF][q];
      acc[v][q] = keep + __shfl_xor_sync(sync_mask, send, HALF);
    }
  }
}

// The lane's inputs of step s: for its rows e = 0, 1: x_proj r/z/n,
// hp r/z/n, h_prev and the cotangent at [8e .. 8e + 8). Padded rows read
// zeros.
template <int H>
__device__ __forceinline__ void load_inputs(const Direction& d, int s, int L,
                                            int B, int b0, int col,
                                            float (&in)[kInputs]) {
  const int t = d.reverse ? s : L - 1 - s;
  const int tp = d.reverse ? t + 1 : t - 1;      // step of h_prev
  const bool has_prev = tp >= 0 && tp < L;
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    float* v = in + 8 * e;
    const int b = b0 + e;
    if (b < B) {
      const float* xp = d.xproj + (static_cast<size_t>(t) * B + b) * 3 * H + col;
      const size_t prev = static_cast<size_t>(tp) * B + b;
      const float* hp = has_prev ? d.hp_outs + prev * 3 * H + col : d.bhh + col;
      v[0] = xp[0];
      v[1] = xp[H];
      v[2] = xp[2 * H];
      v[3] = hp[0];
      v[4] = hp[H];
      v[5] = hp[2 * H];
      v[6] = has_prev ? d.outs[prev * H + col] : 0.f;
      v[7] = d.grad[(static_cast<size_t>(t) * B + b) * H + col];
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = 0.f;
    }
  }
}

template <int H>
__global__ void __launch_bounds__(Shape<H>::kThreads, 1)
gru_bwd_kernel(const __grid_constant__ Directions args, int L, int B) {
  using S = Shape<H>;
  constexpr int U = S::U;
  const Direction& d = args.dir[blockIdx.y];
  const int rank = cluster_rank();
  const int b_tile = (blockIdx.x / kCluster) * kTile;
  const int unit0 = rank * U;
  const int tid = threadIdx.x;
  const int ks = tid % S::KS;
  const int u_group = (tid / S::KS) * S::UT;  // the group's first unit
  const int u = u_group + ks % S::UT;         // this lane's unit (gate math)
  const int col = unit0 + u;                  // ... as a hidden index
  const int b0 = b_tile + kRows * (ks / S::UT);   // its first batch row

  extern __shared__ __align__(16) float smem[];
  float* buf = smem;                          // [2][3H][16], quads rotated
  float* stage = buf + 2 * S::J * kTile;      // [2][3][U][16], quads rotated
  __shared__ __align__(8) uint64_t full_bar[2];

  if (tid == 0) {
    mbar_init(&full_bar[0]);
    mbar_init(&full_bar[1]);
    fence_mbar_init();
  }

  // Exchange row j = (rank' * 3 + g) * U + u' holds dhp of W_hh row
  // g * H + rank' * U + u'. This lane reads rows j = KS i + ks and keeps
  // W_hh[row][unit0 + u_group + v] for its group's UT units v in registers.
  float w[S::kRowsPerLane][S::UT];
#pragma unroll
  for (int i = 0; i < S::kRowsPerLane; ++i) {
    const int j = S::KS * i + ks;
    const int r = j / (3 * U), g = (j / U) % 3, up = j % U;
    const float* row = d.whh + static_cast<size_t>(g * H + r * U + up) * H;
#pragma unroll
    for (int v = 0; v < S::UT; ++v) w[i][v] = row[unit0 + u_group + v];
  }
  // The slots of rows KS i + ks do not depend on i.
  int quad_off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) quad_off[q] = 4 * quad_slot(q, ks);

  float in[kInputs];
  load_inputs<H>(d, 0, L, B, b0, col, in);
  float dh_carry[kRows] = {0.f, 0.f};

  // Every CTA's barriers are initialised before any slice is sent.
  cluster_arrive();
  cluster_wait();

  const uint32_t slice_bytes = S::kSlice * sizeof(float);
  for (int s = 0; s < L; ++s) {
    const int bsel = s & 1;
    const int t = d.reverse ? s : L - 1 - s;

    // Gate math for rows b0, b0 + 1 of unit col.
    float dhz[kRows], out[3][kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const float* v = in + 8 * e;
      const float dh = dh_carry[e] + v[7];
      const float hn = v[5];
      const float r = sigmoidf(v[0] + v[3]);
      const float z = sigmoidf(v[1] + v[4]);
      const float n = tanhf(v[2] + r * hn);
      const float dn_pre = dh * (1.f - z) * (1.f - n * n);
      const float dz_pre = dh * (v[6] - n) * z * (1.f - z);
      const float dr_pre = dn_pre * hn * r * (1.f - r);
      dhz[e] = dh * z;
      out[0][e] = dr_pre;
      out[1][e] = dz_pre;
      out[2][e] = dn_pre * r;
      const int b = b0 + e;
      if (b < B) {
        const size_t i3 = (static_cast<size_t>(t) * B + b) * 3 * H + col;
        d.dxp[i3] = dr_pre;
        d.dxp[i3 + H] = dz_pre;
        d.dxp[i3 + 2 * H] = dn_pre;
        d.dhp[i3] = dr_pre;
        d.dhp[i3 + H] = dz_pre;
        d.dhp[i3 + 2 * H] = dn_pre * r;
      }
    }
    // The next step's inputs are in flight during the exchange and product.
    if (s + 1 < L) load_inputs<H>(d, s + 1, L, B, b0, col, in);

    // This lane's two rows 2p, 2p + 1 (p = ks / UT) of each gate row j:
    // quad p / 2, offset 2 (p % 2). Padded rows carry zeros in and so send
    // zeros.
    float* st = stage + bsel * S::kSlice;
    const int pair = ks / S::UT;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const int j = (rank * 3 + g) * U + u;
      *reinterpret_cast<float2*>(st + (g * U + u) * kTile +
                                 4 * quad_slot(pair >> 1, j) + 2 * (pair & 1)) =
          make_float2(out[g][0], out[g][1]);
    }
    // The slice's generic writes are visible to the bulk copies' reads.
    fence_proxy_async();
    __syncthreads();

    float* rb = buf + bsel * S::J * kTile;
    const uint32_t bar = smem_u32(&full_bar[bsel]);
    if (tid == 0) mbar_expect_tx(bar, kCluster * slice_bytes);
    if (tid < kCluster) {                     // thread k sends to CTA k
      send_to_peer(smem_u32(rb + rank * S::kSlice), smem_u32(st),
                   slice_bytes, bar, tid);
    }
    mbar_wait(bar, (s >> 1) & 1);
    __syncwarp(S::kMask);

    // acc[v][row] = sum over this lane's exchange rows of dhp[row][j] * w.
    float acc[S::UT][kTile];
#pragma unroll
    for (int v = 0; v < S::UT; ++v) {
#pragma unroll
      for (int q = 0; q < kTile; ++q) acc[v][q] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < S::kRowsPerLane; ++i) {
      const float* row = rb + (S::KS * i + ks) * kTile;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(row + quad_off[q]);
#pragma unroll
        for (int v = 0; v < S::UT; ++v) {
          acc[v][4 * q + 0] = fmaf(x.x, w[i][v], acc[v][4 * q + 0]);
          acc[v][4 * q + 1] = fmaf(x.y, w[i][v], acc[v][4 * q + 1]);
          acc[v][4 * q + 2] = fmaf(x.z, w[i][v], acc[v][4 * q + 2]);
          acc[v][4 * q + 3] = fmaf(x.w, w[i][v], acc[v][4 * q + 3]);
        }
      }
    }
    // Reduce-scatter over the group's KS lanes: rows first (16 -> 8 -> 4
    // -> 2, by lane bits KS/2, KS/4, KS/8), then units (UT -> 1, by lane
    // bits UT/2 .. 1), which leaves rows 2p, 2p + 1 of unit ks % UT.
    halve_rows<8, S::KS / 2>(acc, ks, S::kMask);
    halve_rows<4, S::KS / 4>(acc, ks, S::kMask);
    halve_rows<2, S::KS / 8>(acc, ks, S::kMask);
    if constexpr (S::UT == 4) halve_units<2>(acc, ks, S::kMask);
    if constexpr (S::UT >= 2) halve_units<1>(acc, ks, S::kMask);
#pragma unroll
    for (int e = 0; e < kRows; ++e) dh_carry[e] = dhz[e] + acc[0][e];
    // Step s's reads of rb are done; the wait is for the peers' arrival at
    // the end of step s - 1, which every peer made before sending the slice
    // that just landed.
    if (s > 0) cluster_wait();
    cluster_arrive();
  }
  // No CTA leaves while a peer may still address its shared memory.
  cluster_wait();
}

template <int H>
cudaLaunchConfig_t launch_config(int ndir, int B, cudaLaunchAttribute* attr) {
  using S = Shape<H>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + kTile - 1) / kTile) * kCluster, ndir, 1);
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
template <int H>
cudaError_t set_smem_once() {
  static bool done = false;
  if (!done) {
    static_assert(Shape<H>::kSmem <= kMaxSmem, "shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Shape<H>::kSmem));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

template <int H>
cudaError_t launch(const Directions& args, int ndir, int L, int B,
                   cudaStream_t stream) {
  cudaError_t err = set_smem_once<H>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config<H>(ndir, B, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, gru_bwd_kernel<H>, args, L, B);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int H>
cudaError_t max_clusters(int* count) {
  cudaError_t err = set_smem_once<H>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config<H>(1, kTile, attr);
  return cudaOccupancyMaxActiveClusters(count, gru_bwd_kernel<H>, &cfg);
}

}  // namespace

// ptrs: 8 device pointers per direction, in the order x_proj, hp_outs,
// outs, grad, W_hh, b_hh, dx_proj, dhp (shapes as in Direction);
// reverse: one flag per direction; ndir is 1 or 2. H must be one of 16, 32,
// 64, 128, 256. Returns a cudaError_t.
extern "C" int gru_backward(void* const* ptrs, const int* reverse, int ndir,
                            int L, int B, int H, cudaStream_t stream) {
  if (L <= 0 || B <= 0 || ndir < 1 || ndir > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Directions args = {};
  for (int k = 0; k < ndir; ++k) {
    void* const* p = ptrs + 8 * k;
    args.dir[k] = Direction{static_cast<const float*>(p[0]),
                            static_cast<const float*>(p[1]),
                            static_cast<const float*>(p[2]),
                            static_cast<const float*>(p[3]),
                            static_cast<const float*>(p[4]),
                            static_cast<const float*>(p[5]),
                            static_cast<float*>(p[6]),
                            static_cast<float*>(p[7]), reverse[k]};
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

// cudaOccupancyMaxActiveClusters of the kernel at hidden size H: how many
// clusters of 8 CTAs the card holds at once.
extern "C" int gru_backward_max_clusters(int H, int* count) {
  cudaError_t err;
  switch (H) {
    case 16: err = max_clusters<16>(count); break;
    case 32: err = max_clusters<32>(count); break;
    case 64: err = max_clusters<64>(count); break;
    case 128: err = max_clusters<128>(count); break;
    case 256: err = max_clusters<256>(count); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
