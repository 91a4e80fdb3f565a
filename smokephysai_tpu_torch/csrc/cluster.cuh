// Thread-block cluster primitives shared by the solver kernels that keep an
// episode in one cluster's shared memory (fused_step.cu, jacobi.cu): the
// CTA's place in its cluster and the cluster's in the grid, the cluster
// barrier, distributed-shared-memory addresses, the halo handshake, and on
// the host the kernels' attributes and cluster launch configuration.
//
// The halo handshake. Each CTA holds two mbarriers (16 bytes of shared
// memory, each initialised with one arrival): stage k's halo rows arrive on
// the one of parity k & 1. A sender stores its edge rows straight into a
// neighbour's shared memory by st.async, which counts its bytes on the
// neighbour's mbarrier of that stage (complete_tx); the receiver's first
// thread arrives with the bytes it expects (expect_tx), and every thread
// waits on the phase (k >> 1) & 1 with acquire at cluster scope. Bytes may
// land before the expect_tx: the transaction count then goes below zero
// for a while, which the mbarrier allows. Two mbarriers suffice when a CTA
// sends stage k + 1's rows only after it has waited for stage k's: a
// neighbour is then never more than one stage ahead. No MEMBAR.ALL.GPU is
// issued, as a cluster barrier's release would be. A wait that outlasts
// 2^26 polls (a lost halo) traps instead of hanging.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_count() {
  unsigned r;
  asm("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: what was written before is
// seen after, in shared memory (this CTA's and the others') and in global.
// The release is a MEMBAR.ALL.GPU in the SASS.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of shared address `a` in CTA `rank`.
__device__ __forceinline__ uint32_t map_u32(uint32_t a, unsigned rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

// The CTA's two halo mbarriers and the count of stages ended so far.
struct Halos {
  uint32_t bar;  // shared address of the first mbarrier
  int k;
};

// The first thread sets up both mbarriers (one arrival each) and makes
// them visible to the cluster; the caller then meets the cluster (a
// cluster barrier) before any CTA stores into another.
__device__ __forceinline__ void halo_init(uint32_t bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n\t"
      "mbarrier.init.shared::cta.b64 [%1], 1;\n\t"
      "fence.mbarrier_init.release.cluster;" :: "r"(bar), "r"(bar + 8)
      : "memory");
}

// This CTA's mbarrier of the current stage.
__device__ __forceinline__ uint32_t halo_bar(const Halos& hx) {
  return hx.bar + 8 * (hx.k & 1);
}

// One float into another CTA's shared memory (shared::cluster address
// `dst`), counted on its mbarrier `bar` (also a shared::cluster address).
__device__ __forceinline__ void st_async_f32(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Four floats (dst 16-byte aligned), likewise.
__device__ __forceinline__ void st_async_f32x4(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
         "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// The end of a stage's exchange: the first thread expects `bytes` of halo
// on the stage's mbarrier, then every thread waits until they are in.
__device__ __forceinline__ void halo_wait(Halos& hx, uint32_t bytes) {
  const uint32_t bar = halo_bar(hx);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
  const uint32_t parity = (hx.k >> 1) & 1;
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (spins == (1u << 26)) __trap();  // a lost halo: fail, do not hang
  }
  ++hx.k;
}

// ---------------------------------------------------------------- host side

// One kernel instantiation (Fn: its function pointer type) and the
// attributes set on it so far.
template <typename Fn>
struct ClusterKernel {
  Fn fn;
  int smem_set;
  bool nonportable_set;
};

// Dynamic shared memory and the non-portable cluster size (over 8 CTAs),
// set on an instantiation as its launches need them (the largest size
// asked so far).
template <typename Fn>
cudaError_t configure(ClusterKernel<Fn>& k, int smem, int cluster) {
  cudaError_t e = cudaSuccess;
  if (smem > k.smem_set) {
    e = cudaFuncSetAttribute((const void*)k.fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    k.smem_set = smem;
  }
  if (cluster > 8 && !k.nonportable_set) {
    e = cudaFuncSetAttribute((const void*)k.fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    k.nonportable_set = true;
  }
  return e;
}

// A launch of `clusters` clusters of `cluster` CTAs along x, each of bx x
// by threads; attr holds the cluster dimension.
inline cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int cluster,
                                        int clusters, int bx, int by, int smem,
                                        cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters, 1, 1);
  cfg.blockDim = dim3(bx, by, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace
