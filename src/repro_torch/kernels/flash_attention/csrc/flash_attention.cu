// Flash attention, forward, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _fa_kernel)
// of src/repro/kernels/flash_attention/kernel.py: causal or non-causal GQA
// attention of q (B, Sq, H, D) over k, v (B, Skv, K, D), query head h
// reading KV head h / (H / K). Causal queries are the LAST Sq positions of
// the Skv keys: query i sits at position i + Skv - Sq and sees the keys at
// or before it. The math is fp32 whatever the element type (fp32 or bf16, a
// template parameter; q, k and v of one type), the output has q's type. A
// query row that sees no key (causal with Sq > Skv) is exactly 0: the
// Pallas kernel skips every block of such rows (its `live` test) and
// leaves them 0 at the block sizes the JAX package's tests use; the jnp
// oracle returns the mean of V there (ROADMAP.md, section 3).
//
// Bound: operations. A causal S = 4096, H = 16, D = 128 prefill layer is
// 4 * D * H * S (S + 1) / 2 = 68.7 GFLOP over 16 MB of q, k, v and output,
// thousands of flop per byte, far above both ridges. This first kernel runs
// scalar fp32 FMAs on the CUDA cores with both operands from shared memory,
// not the tensor cores, so it sits well above its bound; wgmma and TMA are
// later work.
//
// Design (the TPU kernel's (B, H, q blocks, kv blocks) grid with VMEM
// scratch carried across the sequential kv axis becomes a loop inside the
// block):
//   * one block = one (b, KV head) and a tile of 32 query rows, row r =
//     query i * G + group g (the G heads of a KV head share each staged K/V
//     tile); the heaviest causal tiles are scheduled first;
//   * the block walks the keys in tiles of 32, staged in shared memory as
//     fp32 rows padded to D + 1 floats (conflict-free column reads), and
//     stops at its last row's causal diagonal — the Pallas kernel's `live`
//     block skip; keys past Skv are staged as 0 and masked;
//   * each warp owns 4 rows: lane t scores key t of the tile for all 4 rows
//     at once (one sequential fp32 dot per row, each key element read once
//     for the 4 rows), the warp reduces max and sum with xor butterflies,
//     and lane t owns output features t, t + 32, ...; the online softmax
//     follows kernel.py's rules (running max from -1e30, masked
//     probabilities forced to 0, finish divides by max(l, 1e-30)), and p
//     stays fp32 into the P.V sum.
// A key tile that is fully masked for a row leaves the row's state bitwise
// unchanged (every probability 0, correction exp(0) == 1), so a row's
// result does not depend on its tile, on Sq's tiling or on the block sizes
// the caller passes. No split of the keys across blocks, no atomic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;     // query rows per block
constexpr int kKeys = 32;                        // keys per tile: one a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const scalar_t* __restrict__ q,
                       const scalar_t* __restrict__ k,
                       const scalar_t* __restrict__ v,
                       scalar_t* __restrict__ out, int Sq, int Skv, int H,
                       int K, int causal, float scale) {
  constexpr int kDPL = D / 32;                   // output features per lane
  constexpr int kDP = D + 1;                     // padded smem row
  static_assert(D % 32 == 0, "head dim");

  extern __shared__ float smem[];
  float* k_s = smem;                             // (kKeys, kDP)
  float* v_s = k_s + kKeys * kDP;                // (kKeys, kDP)
  float* q_s = v_s + kKeys * kDP;                // (kRows, kDP)

  const int G = H / K;
  const int n_rows = Sq * G;
  const int q_offset = Skv - Sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heavy first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // keys this tile needs: up to its last row's causal position
  int n_keys = Skv;
  if (causal) {
    const int r_last = min(row0 + kRows, n_rows) - 1;
    n_keys = min(Skv, max(r_last / G + q_offset + 1, 0));
  }

  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows) {
      const int qi = row / G, h = kvh * G + row % G;
      x = to_float(q[((static_cast<int64_t>(b) * Sq + qi) * H + h) * D + d]);
    }
    q_s[r * kDP + d] = x;
  }

  // lim[p]: the keys below it are the ones row p sees (0 for a row past
  // the queries or one that sees none)
  int lim[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
#pragma unroll
  for (int p = 0; p < kRowsPerWarp; ++p) {
    const int row = row0 + warp * kRowsPerWarp + p;
    lim[p] = row >= n_rows ? 0
             : causal     ? min(Skv, max(row / G + q_offset + 1, 0))
                          : Skv;
    m[p] = kNegInf;
    l[p] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPL; ++j) acc[p][j] = 0.f;
  }
  const float* qr = q_s + warp * kRowsPerWarp * kDP;

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();                 // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kKeys * D; idx += blockDim.x) {
      const int t = idx / D, d = idx % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + t < Skv) {
        const int64_t off =
            ((static_cast<int64_t>(b) * Skv + k0 + t) * K + kvh) * D + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      k_s[t * kDP + d] = kx;
      v_s[t * kDP + d] = vx;
    }
    __syncthreads();

    float dot[kRowsPerWarp];
#pragma unroll
    for (int p = 0; p < kRowsPerWarp; ++p) dot[p] = 0.f;
    const float* kr = k_s + lane * kDP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kx = kr[d];
#pragma unroll
      for (int p = 0; p < kRowsPerWarp; ++p)
        dot[p] = fmaf(qr[p * kDP + d], kx, dot[p]);
    }

    float pr[kRowsPerWarp], corr[kRowsPerWarp];
#pragma unroll
    for (int p = 0; p < kRowsPerWarp; ++p) {
      const float s = k0 + lane < lim[p] ? dot[p] * scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[p], mx);
      pr[p] = s > kNegInf * 0.5f ? expf(s - m_new) : 0.f;
      corr[p] = expf(m[p] - m_new);
      float sum = pr[p];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      l[p] = l[p] * corr[p] + sum;
      m[p] = m_new;
    }

    float pv[kRowsPerWarp][kDPL];
#pragma unroll
    for (int p = 0; p < kRowsPerWarp; ++p)
#pragma unroll
      for (int j = 0; j < kDPL; ++j) pv[p][j] = 0.f;
#pragma unroll 4
    for (int t = 0; t < kKeys; ++t) {
      float pt[kRowsPerWarp];
#pragma unroll
      for (int p = 0; p < kRowsPerWarp; ++p)
        pt[p] = __shfl_sync(kFull, pr[p], t);
#pragma unroll
      for (int j = 0; j < kDPL; ++j) {
        const float vx = v_s[t * kDP + lane + 32 * j];
#pragma unroll
        for (int p = 0; p < kRowsPerWarp; ++p)
          pv[p][j] = fmaf(pt[p], vx, pv[p][j]);
      }
    }
#pragma unroll
    for (int p = 0; p < kRowsPerWarp; ++p)
#pragma unroll
      for (int j = 0; j < kDPL; ++j)
        acc[p][j] = acc[p][j] * corr[p] + pv[p][j];
  }

#pragma unroll
  for (int p = 0; p < kRowsPerWarp; ++p) {
    const int row = row0 + warp * kRowsPerWarp + p;
    if (row >= n_rows) continue;
    const int qi = row / G, h = kvh * G + row % G;
    scalar_t* o = out + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
    const float denom = fmaxf(l[p], 1e-30f);     // a row with no key: 0 / .
#pragma unroll
    for (int j = 0; j < kDPL; ++j) store(o + lane + 32 * j, acc[p][j] / denom);
  }
}

template <typename scalar_t, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int K, int causal,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<scalar_t, D>;
  const size_t smem = sizeof(float) * (2 * kKeys + kRows) * (D + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles =
      (static_cast<int64_t>(Sq) * (H / K) + kRows - 1) / kRows;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(tiles), K, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<scalar_t*>(out), Sq, Skv,
      H, K, causal, scale);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int Sq, int Skv, int H, int K,
                     int causal, float scale, cudaStream_t stream) {
#define FA_CASE(DD)                                                        \
  if (D == DD)                                                             \
    return launch<scalar_t, DD>(q, k, v, out, B, Sq, Skv, H, K, causal,    \
                                scale, stream);
  FA_CASE(32) FA_CASE(64) FA_CASE(128) FA_CASE(256)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Skv, K, D), out (B, Sq, H, D), all
// contiguous and of dtype (0 = float32, 1 = bfloat16); causal 0 or 1.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Skv, int H, int K, int D,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Skv < 0 || K <= 0 || H % K != 0 || K > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, out, B, Sq, Skv, H, K, causal, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, K, causal,
                                   scale, s);
  return cudaErrorInvalidValue;
}
