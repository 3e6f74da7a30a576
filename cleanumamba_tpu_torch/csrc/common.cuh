// Shared helpers for the port's kernels: dtype codes, conversions, dispatch.
//
// Every library exposes plain C functions (loaded with ctypes) that take raw
// device pointers, int shapes and the cudaStream_t of the caller, launch on
// that stream, and return cudaGetLastError() so that a refused launch is
// reported by the Python wrapper.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with the Python wrappers (kI8: a stored int8 weight,
// never an activation)
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round through T and back: the value a tensor of dtype T would hold.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Runs the statements that follow with `T` bound to the C++ type of a dtype
// code; an unknown code returns cudaErrorInvalidValue from the caller.
#define DISPATCH_DTYPE(code, T, ...)                        \
  if ((code) == kF32) {                                     \
    using T = float;                                        \
    __VA_ARGS__                                             \
  } else if ((code) == kBF16) {                             \
    using T = __nv_bfloat16;                                \
    __VA_ARGS__                                             \
  } else {                                                  \
    return static_cast<int>(cudaErrorInvalidValue);         \
  }

// ---- Hopper: bulk copies on mbarriers, thread block clusters (inline PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// bytes: a multiple of 16; dst and src 16-byte aligned.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Every thread of every block of the cluster has arrived; shared-memory
// writes made before it are visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  return remote;
}

// The float at `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ float load_cluster(const float* p, int rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(cluster_addr(p, rank)) : "memory");
  return v;
}

// Store v at `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ void store_cluster(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(cluster_addr(p, rank)), "f"(v) : "memory");
}

// ---- tensor cores: TF32 products with fp32 accumulation ----

// D (16 x 8) += A (16 x 8) B (8 x 8), TF32 operands (fp32 bit patterns).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo, both TF32 (lo carries the 11 bits that hi drops).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
