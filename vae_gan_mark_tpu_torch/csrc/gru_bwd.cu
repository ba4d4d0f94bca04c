// GRU recurrence, backward, for Hopper (sm_90a): one thread-block cluster of
// 8 CTAs per tile of 16 batch rows, the same layout as gru_fwd.cu.
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
// The wrapper (ops/gru.py) forms dW_hh = dhp^T @ h_prev and db_hh = sum(dhp)
// after the kernel: they have no sequential dependence.
//
// What bounds it on an H100: as in the forward, the L steps are strictly
// sequential, so the time is L times one step's latency: a (16, 3H) x
// (3H, H/8) product per CTA, the gate math, and the exchange of dhp between
// SMs. The work is 2*L*B*3H*H flops (0.38 GFLOP at L=60, B=16, H=256).
//
// Design. h_prev of every step is known before the backward starts (it is
// the forward's output), so the gate pre-activations need no recurrence:
// the wrapper computes hp_outs = outs @ W_hh^T + b_hh for all steps in one
// product before the kernel, and step t reads the row of its h_prev (b_hh
// itself at the forward's first step, where h_prev = 0).
// That leaves one product per step in the kernel and lets a CTA keep only
// the W_hh columns of its own units (3H x H/8, 96 KB at H=256) in shared
// memory; keeping the rows as well, to recompute hp inside, would need
// another 96 KB, which with the dhp exchange buffers exceeds the 227 KB an
// SM offers. CTA k owns units [k*H/8, (k+1)*H/8): it does the gate math for
// them, writes its slice of dhp into every CTA of the cluster through
// distributed shared memory (double-buffered, one cluster barrier per step),
// and then computes dh_next for its own units from the full dhp. dh_next
// never leaves registers: the thread that computes it for a (row, unit) is
// the one that uses it at the next step. FP32 FMAs throughout (no TF32), to
// match the TPU kernel's HIGHEST precision.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;      // CTAs per cluster; each owns H/8 units
constexpr int kTile = 16;        // batch rows per cluster
constexpr int kMaxItems = 4;     // (row, unit) gate items per thread
constexpr int kMaxThreads = 384;
constexpr size_t kMaxSmem = 227 * 1024;

struct Layout {
  int units;      // hidden units per CTA (= columns of the product)
  int ksplit;     // threads sharing one column, each over 3H / ksplit of j
  int threads;    // units * ksplit
  size_t smem_bytes;
};

Layout make_layout(int hidden) {
  Layout l;
  l.units = hidden / kCluster;
  const int h3 = 3 * hidden;
  int ks = 1;
  while (h3 % (2 * ks) == 0 && l.units * 2 * ks <= kMaxThreads) ks *= 2;
  l.ksplit = ks;
  l.threads = l.units * ks;
  l.smem_bytes = sizeof(float) *
                 (2 * (size_t)h3 * kTile            // dhp, double-buffered
                  + (size_t)h3 * l.units            // W_hh columns
                  + (size_t)ks * kTile * l.units);  // partial sums
  return l;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
gru_bwd_kernel(const float* __restrict__ xproj,
               const float* __restrict__ hp_outs,
               const float* __restrict__ outs,
               const float* __restrict__ grad, const float* __restrict__ whh,
               const float* __restrict__ bhh, float* __restrict__ dxp,
               float* __restrict__ dhp, int L, int B, int H, int ksplit,
               int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / kCluster) * kTile;   // first row of the tile
  const int U = H / kCluster;
  const int H3 = 3 * H;
  const int unit0 = rank * U;
  const int threads = blockDim.x;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* dhp_buf = smem;                      // [2][3H][kTile], j-major
  float* w_s = dhp_buf + 2 * H3 * kTile;      // [3H][U]: W_hh[j][unit0 + u]
  float* part = w_s + H3 * U;                 // [ksplit][kTile][U]

  for (int i = tid; i < H3 * U; i += threads) {
    const int j = i / U, u = i - j * U;
    w_s[i] = whh[static_cast<size_t>(j) * H + unit0 + u];
  }
  // Every CTA of the cluster runs before any CTA writes into another.
  cluster.sync();

  const int col = tid % U;
  const int kq = tid / U;
  const int kc = H3 / ksplit;
  const int n_items = kTile * U;              // item = row * U + unit

  float dh_carry[kMaxItems];                  // dL/dh from the later steps
  float dhz[kMaxItems];                       // dh * z of this step
#pragma unroll
  for (int j = 0; j < kMaxItems; ++j) dh_carry[j] = dhz[j] = 0.f;

  for (int s = 0; s < L; ++s) {
    // The forward walked t = s (or L-1-s when reverse); go the other way.
    const int t = reverse ? s : L - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;     // step of h_prev
    const bool has_prev = tp >= 0 && tp < L;
    float* buf = dhp_buf + (s & 1) * H3 * kTile;

#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      const int item = tid + j * threads;
      if (item < n_items) {
        const int b = item / U, u = item - b * U;
        float dr_pre = 0.f, dz_pre = 0.f, dhn_pre = 0.f;   // padded rows: 0
        dhz[j] = 0.f;
        if (b0 + b < B) {
          const size_t row = static_cast<size_t>(t) * B + b0 + b;
          const size_t i3 = row * H3 + unit0 + u;
          const size_t i1 = row * H + unit0 + u;
          const size_t prev = static_cast<size_t>(tp) * B + b0 + b;
          const float* hp = has_prev ? hp_outs + prev * H3 + unit0 + u
                                     : bhh + unit0 + u;
          const float h_prev = has_prev ? outs[prev * H + unit0 + u] : 0.f;
          const float dh = dh_carry[j] + grad[i1];
          const float hn = hp[2 * H];
          const float r = sigmoidf(xproj[i3] + hp[0]);
          const float z = sigmoidf(xproj[i3 + H] + hp[H]);
          const float n = tanhf(xproj[i3 + 2 * H] + r * hn);
          const float dn_pre = dh * (1.f - z) * (1.f - n * n);
          dz_pre = dh * (h_prev - n) * z * (1.f - z);
          dr_pre = dn_pre * hn * r * (1.f - r);
          dhn_pre = dn_pre * r;
          dhz[j] = dh * z;
          dxp[i3] = dr_pre;
          dxp[i3 + H] = dz_pre;
          dxp[i3 + 2 * H] = dn_pre;
          dhp[i3] = dr_pre;
          dhp[i3 + H] = dz_pre;
          dhp[i3 + 2 * H] = dhn_pre;
        }
        const int jr = unit0 + u;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) {
          float* remote = cluster.map_shared_rank(buf, q);
          remote[jr * kTile + b] = dr_pre;
          remote[(H + jr) * kTile + b] = dz_pre;
          remote[(2 * H + jr) * kTile + b] = dhn_pre;
        }
      }
    }
    // Publishes dhp to every CTA; the other buffer is free for step s + 1.
    cluster.sync();

    // acc[b] = sum over my j range of dhp[b][j] * W_hh[j][unit0 + col].
    float acc[kTile];
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[b] = 0.f;
    const int j_begin = kq * kc;
    for (int jj = j_begin; jj < j_begin + kc; ++jj) {
      const float w = w_s[jj * U + col];
      const float4* dv = reinterpret_cast<const float4*>(buf + jj * kTile);
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) {
        const float4 v = dv[q];
        acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int b = 0; b < kTile; ++b) part[(kq * kTile + b) * U + col] = acc[b];
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      const int item = tid + j * threads;
      if (item < n_items) {
        const int b = item / U, u = item - b * U;
        float sum = dhz[j];
        for (int p = 0; p < ksplit; ++p) sum += part[(p * kTile + b) * U + u];
        dh_carry[j] = sum;
      }
    }
    // The next step's cluster barrier orders these reads of part before
    // the next writes to it.
  }
}

}  // namespace

extern "C" int gru_backward(const float* xproj, const float* hp_outs,
                            const float* outs, const float* grad,
                            const float* whh, const float* bhh, float* dxp,
                            float* dhp, int L, int B, int H, int reverse,
                            cudaStream_t stream) {
  if (L <= 0 || B <= 0 || H <= 0 || H % kCluster != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay = make_layout(H);
  if (lay.smem_bytes > kMaxSmem ||
      (kTile * lay.units + lay.threads - 1) / lay.threads > kMaxItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + kTile - 1) / kTile) * kCluster, 1, 1);
  cfg.blockDim = dim3(lay.threads, 1, 1);
  cfg.dynamicSmemBytes = lay.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gru_bwd_kernel, xproj, hp_outs, outs, grad,
                           whh, bhh, dxp, dhp, L, B, H, lay.ksplit, reverse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
