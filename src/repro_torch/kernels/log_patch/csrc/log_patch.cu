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
// Bound: bytes. Every page row is read once, from the pool or, for a row
// a record wins, from that record's payload, and written once; with the
// records' int32 page, slot and valid that is 2 P T C pool elements +
// 12 N bytes (+ the winners' extra bytes where a payload is wider than the
// pool); there is no arithmetic. P 682, T 16, C 2048, N 256 in bf16:
// 89.4 MB, 0.0267 ms at 3.35 TB/s.
//
// Design: winner-first, one block per page (ownership by page keeps
// last-writer-wins without any ordering between blocks).
//   * Winners are resolved first: win[T] in dynamic shared memory, set to
//     -1; the threads take the records in parallel (n = tid, tid +
//     blockDim, ...), and a valid record whose clamped page is this block's
//     does atomicMax(&win[clamped slot], n). The largest log index is the
//     last writer in log order, so the result does not depend on thread
//     timing. One __syncthreads.
//   * Then every row of the page is written exactly once: from payload row
//     win[t] (converted in registers) when win[t] >= 0, else from the pool
//     row.
//   * Vector route: 16-byte loads and stores (8 bf16 or 4 fp32 a thread),
//     kUnroll of them in flight a thread before its stores; taken when a
//     pool row is a multiple of 16 bytes and the pool, payload and output
//     pointers are 16-byte aligned (then every payload row is aligned for
//     its 8- or 32-byte reads too). An fp32 payload into a bf16 pool is two
//     16-byte loads into one 16-byte store.
//   * Scalar route, on the same winner table, in every other case (a row
//     that is not a multiple of 16 bytes, a pool view at an unaligned
//     offset): one element a thread, kUnroll in flight.
// N = 0, valid == nullptr, any T and N much larger than the block take the
// same path; win[] holds T ints (T > 58,112 does not fit and is refused).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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

// two fp32 rounded to bf16 (round to nearest even), packed low first
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 16 bytes of pool_t read from element c of a payload row of pay_t
template <typename pool_t, typename pay_t>
__device__ __forceinline__ uint4 load_payload16(const pay_t* row, int64_t c) {
  if constexpr (sizeof(pool_t) == sizeof(pay_t)) {
    return *reinterpret_cast<const uint4*>(row + c);
  } else if constexpr (sizeof(pay_t) == 4) {        // 8 fp32 -> 8 bf16
    const float4 a = *reinterpret_cast<const float4*>(row + c);
    const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
    return make_uint4(bf16x2_bits(a.x, a.y), bf16x2_bits(a.z, a.w),
                      bf16x2_bits(b.x, b.y), bf16x2_bits(b.z, b.w));
  } else {                                          // 4 bf16 -> 4 fp32
    const uint2 raw = *reinterpret_cast<const uint2*>(row + c);
    return make_uint4(raw.x << 16, raw.x & 0xffff0000u, raw.y << 16,
                      raw.y & 0xffff0000u);        // bf16 is fp32's top half
  }
}

template <typename pool_t, typename pay_t, bool kVec>
__global__ void __launch_bounds__(kThreads)
log_patch_kernel(const pool_t* __restrict__ pool,
                 const pay_t* __restrict__ payloads,
                 const int32_t* __restrict__ page_idx,
                 const int32_t* __restrict__ slot_idx,
                 const int32_t* __restrict__ valid,
                 pool_t* __restrict__ out, int P, int T, int C, int N) {
  extern __shared__ int win[];                   // (T,): winning record
  const int p = blockIdx.x;
  for (int t = threadIdx.x; t < T; t += blockDim.x) win[t] = -1;
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (min(max(page_idx[n], 0), P - 1) != p) continue;
    if (valid != nullptr && valid[n] == 0) continue;
    atomicMax(&win[min(max(slot_idx[n], 0), T - 1)], n);  // later wins
  }
  __syncthreads();

  const int64_t page = static_cast<int64_t>(p) * T * C;
  if constexpr (kVec) {
    constexpr int kW = 16 / sizeof(pool_t);      // elements a vector
    const int cv = C / kW;                       // vectors a row
    const int total = T * cv;
    const uint4* src = reinterpret_cast<const uint4*>(pool + page);
    uint4* dst = reinterpret_cast<uint4*>(out + page);
    for (int i0 = threadIdx.x; i0 < total; i0 += kUnroll * blockDim.x) {
      uint4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total) {
          const int t = i / cv, w = win[t];
          x[u] = w < 0 ? src[i]
                       : load_payload16<pool_t>(
                             payloads + static_cast<int64_t>(w) * C,
                             static_cast<int64_t>(i - t * cv) * kW);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total) dst[i] = x[u];
      }
    }
  } else {
    const int total = T * C;
    for (int i0 = threadIdx.x; i0 < total; i0 += kUnroll * blockDim.x) {
      pool_t x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total) {
          const int t = i / C, w = win[t];
          x[u] = w < 0 ? pool[page + i]
                       : from_float<pool_t>(to_float(
                             payloads[static_cast<int64_t>(w) * C + i -
                                      static_cast<int64_t>(t) * C]));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total) out[page + i] = x[u];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
// the vector route: a pool row a multiple of 16 bytes, the three pointers
// 16-byte aligned
bool vector_route(const void* pool, const void* payloads, const void* out,
                  int C, int elem_bytes) {
  return (static_cast<int64_t>(C) * elem_bytes) % 16 == 0 &&
         aligned16(pool) && aligned16(payloads) && aligned16(out);
}

template <typename pool_t, typename pay_t, bool kVec>
cudaError_t launch_route(const void* pool, const void* payloads,
                         const void* page_idx, const void* slot_idx,
                         const void* valid, void* out, int P, int T, int C,
                         int N, cudaStream_t stream) {
  auto kernel = log_patch_kernel<pool_t, pay_t, kVec>;
  const size_t smem = sizeof(int) * static_cast<size_t>(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<P, kThreads, smem, stream>>>(
      static_cast<const pool_t*>(pool), static_cast<const pay_t*>(payloads),
      static_cast<const int32_t*>(page_idx),
      static_cast<const int32_t*>(slot_idx),
      static_cast<const int32_t*>(valid), static_cast<pool_t*>(out), P, T, C,
      N);
  return cudaGetLastError();
}

template <typename pool_t, typename pay_t>
cudaError_t launch(const void* pool, const void* payloads,
                   const void* page_idx, const void* slot_idx,
                   const void* valid, void* out, int P, int T, int C, int N,
                   cudaStream_t stream) {
  return vector_route(pool, payloads, out, C, sizeof(pool_t))
             ? launch_route<pool_t, pay_t, true>(pool, payloads, page_idx,
                                                 slot_idx, valid, out, P, T,
                                                 C, N, stream)
             : launch_route<pool_t, pay_t, false>(pool, payloads, page_idx,
                                                  slot_idx, valid, out, P, T,
                                                  C, N, stream);
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

// The route log_patch_launch takes for these arguments: 1 = vector (16-byte
// loads and stores), 0 = scalar.
extern "C" int log_patch_route(const void* pool, const void* payloads,
                               const void* out, int C, int pool_dtype) {
  return vector_route(pool, payloads, out, C, pool_dtype == 0 ? 4 : 2);
}

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
  if (N < 0 || static_cast<int64_t>(T) * C > (1 << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 0)
    return dispatch<float>(pay_dtype, pool, payloads, page_idx, slot_idx,
                           valid, out, P, T, C, N, s);
  if (pool_dtype == 1)
    return dispatch<__nv_bfloat16>(pay_dtype, pool, payloads, page_idx,
                                   slot_idx, valid, out, P, T, C, N, s);
  return cudaErrorInvalidValue;
}
