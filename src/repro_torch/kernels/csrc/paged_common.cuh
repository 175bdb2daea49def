// Pieces K2 (paged_attention.cu), K3 (int_attention.cu) and K4
// (paged_attention_mla.cu) share: the compute-dtype conversions, 16-byte
// cp.async loads, programmatic dependent launches, and the opt-in
// shared-memory raise.
#pragma once

#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to nearest-even in T and widened back to f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__host__ __device__ __forceinline__ size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group have landed (for this thread)
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// every group has landed (for this thread)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Programmatic dependent launch: a kernel launched with programmatic stream
// serialization may start while the one before it runs; it waits here for
// that kernel to finish and its writes to be visible.
__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// lets the next kernel's CTAs start (they wait in wait_previous_grid)
__device__ __forceinline__ void start_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ------------------------------------------------------------ host

// The opt-in shared memory of the current card, read once.
int smem_optin(int* limit) {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      cached = -1;
      return static_cast<int>(err);
    }
  }
  *limit = cached;
  return 0;
}

// Lets `kernel` take `bytes` of dynamic shared memory (raised once per size).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int* allowed) {
  if (static_cast<int>(bytes) <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = static_cast<int>(bytes);
  return err;
}

}  // namespace
