// Log patch for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel log_patch_pallas (body _lp_kernel) of
// src/repro/kernels/log_patch/kernel.py: the logging design's drain path.
// N log records — payload rows (N, C) with (page, slot) targets and a valid
// flag — are replayed onto a page pool (P, T, C); the result is a new pool
// (out of place). Records apply in log order, so of two records with one
// target the later wins; records with valid == 0 are skipped; page and slot
// indices are clamped into [0, P) and [0, T), as the Pallas kernel clamps
// them (its jnp oracle drops out-of-range records instead: ROADMAP.md,
// section 3). A payload is converted to the pool's type (fp32 or bf16 each).
//
// Bound: bytes. Every page is read once and written once (2 * P * T * C
// elements) and each record's payload is read by the one block that owns
// its page; there is no arithmetic.
//
// Design (the TPU's own mapping, which keeps last-writer-wins without any
// ordering between blocks): one block per page. Thread x owns the columns
// c = x, x + blockDim, ... of the page: it copies them for every slot, then
// scans the N records in log order and writes, for each record that targets
// this page and is valid, the payload's column c at the record's slot. A
// given element is written only by its owning thread, in program order, so
// the last matching record in the log is the value that stays. Records
// never race: a scatter per record (atomics, index_put) would not keep the
// order when targets collide.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename pool_t, typename pay_t>
__global__ void __launch_bounds__(kThreads)
log_patch_kernel(const pool_t* __restrict__ pool,
                 const pay_t* __restrict__ payloads,
                 const int32_t* __restrict__ page_idx,
                 const int32_t* __restrict__ slot_idx,
                 const int32_t* __restrict__ valid,
                 pool_t* __restrict__ out, int P, int T, int C, int N) {
  const int p = blockIdx.x;
  const int64_t page = static_cast<int64_t>(p) * T * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    for (int t = 0; t < T; ++t) out[page + t * C + c] = pool[page + t * C + c];
  for (int n = 0; n < N; ++n) {                  // log order: later wins
    if (min(max(page_idx[n], 0), P - 1) != p) continue;
    if (valid != nullptr && valid[n] == 0) continue;
    const int slot = min(max(slot_idx[n], 0), T - 1);
    const pay_t* rec = payloads + static_cast<int64_t>(n) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      out[page + slot * C + c] = from_float<pool_t>(to_float(rec[c]));
  }
}

template <typename pool_t, typename pay_t>
cudaError_t launch(const void* pool, const void* payloads,
                   const void* page_idx, const void* slot_idx,
                   const void* valid, void* out, int P, int T, int C, int N,
                   cudaStream_t stream) {
  log_patch_kernel<pool_t, pay_t><<<P, kThreads, 0, stream>>>(
      static_cast<const pool_t*>(pool), static_cast<const pay_t*>(payloads),
      static_cast<const int32_t*>(page_idx),
      static_cast<const int32_t*>(slot_idx),
      static_cast<const int32_t*>(valid), static_cast<pool_t*>(out), P, T, C,
      N);
  return cudaGetLastError();
}

template <typename pool_t>
cudaError_t dispatch(int pay_dtype, const void* pool, const void* payloads,
                     const void* page_idx, const void* slot_idx,
                     const void* valid, void* out, int P, int T, int C, int N,
                     cudaStream_t stream) {
  if (pay_dtype == 0)
    return launch<pool_t, float>(pool, payloads, page_idx, slot_idx, valid,
                                 out, P, T, C, N, stream);
  if (pay_dtype == 1)
    return launch<pool_t, __nv_bfloat16>(pool, payloads, page_idx, slot_idx,
                                         valid, out, P, T, C, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// pool and out (P, T, C) of pool_dtype, payloads (N, C) of pay_dtype
// (0 = float32, 1 = bfloat16), page_idx / slot_idx (N,) int32, valid (N,)
// int32 or null (every record valid); all contiguous. Returns a cudaError_t
// (0 = launched).
extern "C" int log_patch_launch(const void* pool, const void* payloads,
                                const void* page_idx, const void* slot_idx,
                                const void* valid, void* out, int P, int T,
                                int C, int N, int pool_dtype, int pay_dtype,
                                void* stream) {
  if (P <= 0 || T <= 0 || C <= 0) return cudaSuccess;
  if (N < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 0)
    return dispatch<float>(pay_dtype, pool, payloads, page_idx, slot_idx,
                           valid, out, P, T, C, N, s);
  if (pool_dtype == 1)
    return dispatch<__nv_bfloat16>(pay_dtype, pool, payloads, page_idx,
                                   slot_idx, valid, out, P, T, C, N, s);
  return cudaErrorInvalidValue;
}
