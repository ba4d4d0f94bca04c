// GRU recurrence, forward, for Hopper (sm_90a): one thread-block cluster of
// 8 CTAs per tile of 16 batch rows.
//
// Replaces vae_gan_mark_tpu/ops/pallas/gru.py:_gru_kernel (reached through
// pallas_gru_layer). Same function: from h0 = 0, for each step t
//   hp = h @ W_hh^T + b_hh
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h = (1 - z) * n + z * h,   out[t] = h
// with x_proj = x @ W_ih^T + b_ih precomputed, time-major (L, B, 3H), gate
// order (r, z, n), W_hh in torch's (3H, H) layout, all float32. ``reverse``
// walks t from L-1 down to 0 and writes out[t] in input order, which replaces
// the flip before and after the TPU kernel.
//
// What bounds it on an H100: not HBM and not FP32 throughput. The work is
// 2*L*B*H*3H flops (0.38 GFLOP at L=60, B=16, H=256: about 6 us at the
// card's 67 TFLOP/s), but the L steps are strictly sequential, so the time is
// L times the latency of one step: one (16, H) x (H, 3H/8) product per CTA,
// the gate math, and the exchange of the new h between SMs.
//
// What the design does about it: W_hh (768 KB in f32 at H=256) does not fit
// one SM's 227 KB, so the 8 CTAs of a cluster split the hidden units. CTA k
// owns units [k*H/8, (k+1)*H/8) and keeps the matching r/z/n rows of W_hh
// (96 KB at H=256) in shared memory for all L steps: W_hh is read from HBM
// once. h lives in shared memory, double-buffered; each step a CTA computes
// its gate slice with FP32 FMAs (no TF32, to match the TPU kernel's HIGHEST
// precision), writes its slice of the new h into every CTA of the cluster
// through distributed shared memory, and the cluster meets at one barrier.
// h never goes through HBM, and a step's x_proj loads are issued before the
// product so that their latency hides behind it. Batch tiles are independent
// clusters, so B only changes the grid.

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
  int units;      // hidden units per CTA
  int cols;       // W_hh rows per CTA: r, z and n for each unit
  int ksplit;     // threads sharing one column, each over H / ksplit of k
  int threads;    // cols * ksplit
  size_t smem_bytes;
};

Layout make_layout(int hidden) {
  Layout l;
  l.units = hidden / kCluster;
  l.cols = 3 * l.units;
  int ks = 1;
  while (hidden % (2 * ks) == 0 && 2 * ks <= hidden &&
         l.cols * 2 * ks <= kMaxThreads) {
    ks *= 2;
  }
  l.ksplit = ks;
  l.threads = l.cols * ks;
  l.smem_bytes = sizeof(float) *
                 (2 * (size_t)hidden * kTile          // h, double-buffered
                  + (size_t)hidden * l.cols           // W_hh slice
                  + (size_t)ks * kTile * l.cols       // partial sums
                  + (size_t)l.cols);                  // b_hh slice
  return l;
}

__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_kernel(const float* __restrict__ xproj, const float* __restrict__ whh,
               const float* __restrict__ bhh, float* __restrict__ out,
               int L, int B, int H, int ksplit, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / kCluster) * kTile;   // first row of the tile
  const int U = H / kCluster;
  const int NC = 3 * U;
  const int unit0 = rank * U;
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const size_t H3 = 3 * static_cast<size_t>(H);

  extern __shared__ __align__(16) float smem[];
  float* h_buf = smem;                        // [2][H][kTile], k-major
  float* w_s = h_buf + 2 * H * kTile;         // [H][NC], k-major
  float* part = w_s + H * NC;                 // [ksplit][kTile][NC]
  float* b_s = part + ksplit * kTile * NC;    // [NC]

  for (int i = tid; i < 2 * H * kTile; i += threads) h_buf[i] = 0.f;
  // Column c = g * U + u holds W_hh row g * H + unit0 + u (gate g, unit u).
  for (int i = tid; i < NC * H; i += threads) {
    const int c = i / H, k = i - c * H;
    const int g = c / U, u = c - g * U;
    w_s[k * NC + c] = whh[static_cast<size_t>(g * H + unit0 + u) * H + k];
  }
  for (int c = tid; c < NC; c += threads) {
    const int g = c / U, u = c - g * U;
    b_s[c] = bhh[g * H + unit0 + u];
  }
  // Every CTA's buffers are zeroed before any CTA writes into them.
  cluster.sync();

  const int col = tid % NC;
  const int ks = tid / NC;
  const int kc = H / ksplit;
  const int n_items = kTile * U;              // item = row * U + unit

  for (int s = 0; s < L; ++s) {
    const int t = reverse ? L - 1 - s : s;
    const float* h_cur = h_buf + (s & 1) * H * kTile;
    float* h_next = h_buf + ((s + 1) & 1) * H * kTile;

    float xr[kMaxItems], xz[kMaxItems], xn[kMaxItems];
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      xr[j] = xz[j] = xn[j] = 0.f;
      const int item = tid + j * threads;
      const int b = item / U;
      if (item < n_items && b0 + b < B) {
        const float* xp = xproj + (static_cast<size_t>(t) * B + b0 + b) * H3
                          + unit0 + (item - b * U);
        xr[j] = xp[0];
        xz[j] = xp[H];
        xn[j] = xp[2 * H];
      }
    }

    // acc[b] = sum over my k range of h[b][k] * W_hh[col][k].
    float acc[kTile];
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[b] = 0.f;
    const int k_begin = ks * kc;
    for (int k = k_begin; k < k_begin + kc; ++k) {
      const float w = w_s[k * NC + col];
      const float4* hv = reinterpret_cast<const float4*>(h_cur + k * kTile);
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) {
        const float4 v = hv[q];
        acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int b = 0; b < kTile; ++b) part[(ks * kTile + b) * NC + col] = acc[b];
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      const int item = tid + j * threads;
      if (item < n_items) {
        const int b = item / U, u = item - b * U;
        float hr = 0.f, hz = 0.f, hn = 0.f;
        for (int p = 0; p < ksplit; ++p) {
          const float* row = part + (p * kTile + b) * NC;
          hr += row[u];
          hz += row[U + u];
          hn += row[2 * U + u];
        }
        hr += b_s[u];
        hz += b_s[U + u];
        hn += b_s[2 * U + u];
        const int idx = (unit0 + u) * kTile + b;
        float h_new = 0.f;                    // padded rows stay zero
        if (b0 + b < B) {
          const float r = 1.f / (1.f + expf(-(xr[j] + hr)));
          const float z = 1.f / (1.f + expf(-(xz[j] + hz)));
          const float n = tanhf(xn[j] + r * hn);
          h_new = (1.f - z) * n + z * h_cur[idx];
          out[(static_cast<size_t>(t) * B + b0 + b) * H + unit0 + u] = h_new;
        }
#pragma unroll
        for (int q = 0; q < kCluster; ++q) {
          cluster.map_shared_rank(h_next, q)[idx] = h_new;
        }
      }
    }
    // Publishes the new h to every CTA and frees h_cur for step s + 2.
    cluster.sync();
  }
}

}  // namespace

extern "C" int gru_forward(const float* xproj, const float* whh,
                           const float* bhh, float* out, int L, int B, int H,
                           int reverse, cudaStream_t stream) {
  if (L <= 0 || B <= 0 || H <= 0 || H % kCluster != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay = make_layout(H);
  if (lay.smem_bytes > kMaxSmem ||
      (kTile * lay.units + lay.threads - 1) / lay.threads > kMaxItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  err = cudaLaunchKernelEx(&cfg, gru_fwd_kernel, xproj, whh, bhh, out, L, B,
                           H, lay.ksplit, reverse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
