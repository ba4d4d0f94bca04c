// Device helpers shared by the GRU kernels (gru_fwd.cu, gru_bwd.cu): the
// exchange of a CTA's slice with every CTA of its thread-block cluster by
// bulk async copies (cp.async.bulk shared::cta -> shared::cluster) that
// complete on each receiver's own mbarrier, and the cluster barrier split
// into arrive and wait.
//
// The protocol both kernels follow, per step s:
//   - write the slice into this CTA's staging buffer, fence_proxy_async(),
//     __syncthreads();
//   - thread 0 arms its receive barrier (mbar_expect_tx) for the 8 slices
//     that will land; thread k sends the slice to CTA k (send_to_peer);
//   - mbar_wait on the receive barrier, read the received buffer;
//   - cluster_arrive after the reads, cluster_wait one step later: the
//     receive and staging buffers are double-buffered, and the wait orders
//     a buffer's reads before the next writes into it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cluster_exchange {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return static_cast<int>(rank);
}

// The address in CTA ``rank``'s shared memory that matches ``addr`` in this
// CTA's.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// One thread initialises each receive barrier (one arrival per phase: the
// owner's expect_tx); fence_mbar_init then makes them visible to the
// cluster's copies, before the first cluster barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The owner's arrival for this phase, expecting ``bytes`` of copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
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

// A thread's generic writes to shared memory are visible to the bulk
// copies' reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copies ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// ``src`` in this CTA to ``dst`` in CTA ``peer``, completing on the peer's
// barrier at ``bar``; ``dst`` and ``bar`` are given as this CTA's shared
// addresses.
__device__ __forceinline__ void send_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar,
                                             int peer) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
      "::bytes [%0], [%1], %2, [%3];" ::"r"(cluster_addr(dst, peer)),
      "r"(src), "r"(bytes), "r"(cluster_addr(bar, peer))
      : "memory");
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

}  // namespace cluster_exchange
