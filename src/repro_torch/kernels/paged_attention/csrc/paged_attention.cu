// Ragged-query paged attention for Hopper (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of the JAX package,
// src/repro/kernels/paged_attention/kernel.py:
//   * paged_attention_ragged_pallas (body _pa_ragged_kernel, online-softmax
//     step _ragged_softmax_step) — the fused serving tick's attention;
//   * paged_attention_pallas (body _pa_kernel) — single-token decode. The
//     port launches THIS kernel with Qmax = 1 and q_lens = 1 for it, so "the
//     ragged entry at q_len == 1 is bit for bit the decode entry" holds by
//     construction;
//   * paged_attention_ragged_q8_pallas (body _pa_ragged_q8_kernel) — the
//     same attention over int8 K/V pages with bf16 per-(token, head) scale
//     planes (entry paged_attention_layers_ragged_q8_launch; its decode
//     slice paged_attention_q8 is again this kernel at Qmax = 1);
//   * the multi-layer entries paged_attention_layers_ragged_pallas,
//     paged_attention_layers_pallas and
//     paged_attention_layers_ragged_q8_pallas — the same bodies over all L
//     layers of an (L, P, T, K, D) pool in one launch, one block table and
//     one lengths / q_lens shared by every layer (the TPU runs the
//     single-layer bodies with batch_axis=1). Here the grid's z axis runs
//     over L * B (layer l = z / B, row b = z % B) and each block offsets its
//     q, pool, scale and output pointers by 64-bit per-layer strides. A
//     single-layer call is L = 1: one code path, so layer l of a
//     multi-layer launch is bit for bit the single-layer launch on pool[l].
//
// What it computes (from what _pa_ragged_kernel computes, not from its
// TPU block layout): q (B, Qmax, H, D) attends a pool (P, T, K, D) of
// T-token pages through block_table (B, MP). Query i of row b sits at
// position lengths[b] - q_lens[b] + i and sees pool positions at or before
// it (causal inside the chunk); GQA maps head h to KV head h / (H / K).
// Slots i >= q_lens[b] and q_lens[b] == 0 rows are exactly 0. The math is
// fp32 whatever the element type (q fp32 or bf16, a template parameter; the
// pool of q's type, or int8 with scales); the output has q's type.
//
// Bound: HBM bytes. Each live K/V page is needed once per (row, KV head)
// and the arithmetic intensity is ~2 * rows-per-KV-head flop/byte, far under
// the card's ~295 flop/byte bf16 ridge, so the kernel's job is to read each
// live page once per block and touch no dead page. (fp32 inputs at long
// chunks sit near the ~20 flop/byte ridge of fp32 outside the tensor cores.)
// The int8 layout halves the page bytes (2 * D + 4 bytes per token and KV
// head against 4 * D in bf16), so its pages are read as int8 and
// dequantized on the way into shared memory, never materialized in HBM.
//
// Design:
//   * one block = one (b, kv head) and a tile of 16 of the Qmax*G query
//     rows (row r = query i * G + group g, the TPU kernel's QG order); the
//     TPU's sequential page grid axis becomes a loop over the live pages,
//     stopping at the tile's last causal position, so early tiles of a
//     chunk never load pages only later queries see;
//   * table[b, p] is read in the block and clamped into [0, P); entries past
//     the live pages are never read, so dead table tails can hold anything;
//   * each page's K and V for the head are staged in shared memory as fp32
//     (rows padded to D + 1 floats: conflict-free column reads); an int8
//     page is dequantized there as float(int8) * float(bf16 scale), one
//     rounded product stored before any use (the JAX body's order), so no
//     multiply can be contracted into a later FMA;
//   * a row is owned by a segment of T lanes of one warp: lane t scores key
//     t (a sequential fp32 dot), the segment reduces max and sum with xor
//     butterflies, and lane t owns output features t, t + T, ...; the online
//     softmax follows kernel.py's rules — running max starts at -1e30,
//     masked probabilities are forced to 0 and multiply nothing (a dead
//     slot's value, int8 * 1e6 scale included, is never read), the finish
//     divides by max(l, 1e-30).
// A row's arithmetic does not depend on the tile, on Qmax or on the rows
// around it: a page that is fully masked for a row leaves its state bitwise
// unchanged (corr == exp(0) == 1, every probability 0), so stopping the
// page loop at a tile-dependent bound changes no bit. There is no split of
// the pages across blocks and no atomic. wgmma, TMA and page pipelining are
// left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// kv_t is scalar_t (dense pool) or int8_t (pool_ks/pool_vs then hold the
// bf16 per-(token, head) scales; unused and null for a dense pool)
template <typename scalar_t, typename kv_t, int D, int T>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_ragged_kernel(const scalar_t* __restrict__ q,
                              const kv_t* __restrict__ pool_k,
                              const kv_t* __restrict__ pool_v,
                              const __nv_bfloat16* __restrict__ pool_ks,
                              const __nv_bfloat16* __restrict__ pool_vs,
                              const int32_t* __restrict__ table,
                              const int32_t* __restrict__ lengths,
                              const int32_t* __restrict__ q_lens,
                              scalar_t* __restrict__ out, int B, int Qm,
                              int H, int K, int P, int MP, int64_t q_ls,
                              int64_t pool_ls, int64_t scale_ls,
                              float scale) {
  constexpr int kSegs = 32 / T;                  // rows a warp runs at once
  constexpr int kPasses = kRowsPerWarp / kSegs;
  constexpr int kDPL = D / T;                    // features per lane
  constexpr int kDP = D + 1;                     // padded smem row
  static_assert(32 % T == 0 && kRowsPerWarp % kSegs == 0, "page size");
  static_assert(D % T == 0, "head dim");
  constexpr bool kQ8 = std::is_same<kv_t, int8_t>::value;

  extern __shared__ float smem[];
  float* k_s = smem;                             // (T, kDP)
  float* v_s = k_s + T * kDP;                    // (T, kDP)
  float* q_s = v_s + T * kDP;                    // (kRowsPerBlock, kDP)

  const int kv = blockIdx.y;
  const int layer = blockIdx.z / B, b = blockIdx.z % B;
  q += layer * q_ls;
  out += layer * q_ls;
  pool_k += layer * pool_ls;
  pool_v += layer * pool_ls;
  if constexpr (kQ8) {
    pool_ks += layer * scale_ls;
    pool_vs += layer * scale_ls;
  }
  const int G = H / K;
  const int n_rows = Qm * G;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int length = lengths[b];
  const int q_len = q_lens[b];
  const int valid_end = min(n_rows, max(q_len, 0) * G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane / T, sl = lane % T;

  // pages this tile needs: up to its last valid query's causal position
  int n_pages = 0;
  if (row0 < valid_end) {
    const int r_last = min(row0 + kRowsPerBlock, valid_end) - 1;
    const int pos_last = length - q_len + r_last / G;
    n_pages = pos_last >= 0 ? min(pos_last / T + 1, MP) : 0;
  }

  for (int idx = threadIdx.x; idx < kRowsPerBlock * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < valid_end) {
      const int qi = row / G, h = kv * G + row % G;
      x = to_float(q[((static_cast<int64_t>(b) * Qm + qi) * H + h) * D + d]);
    }
    q_s[r * kDP + d] = x;
  }

  float m[kPasses], l[kPasses], acc[kPasses][kDPL];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    m[p] = kNegInf;
    l[p] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPL; ++j) acc[p][j] = 0.f;
  }

  for (int pg = 0; pg < n_pages; ++pg) {
    const int phys = min(max(table[static_cast<int64_t>(b) * MP + pg], 0),
                         P - 1);
    __syncthreads();                 // the previous page's readers are done
    for (int idx = threadIdx.x; idx < T * D; idx += blockDim.x) {
      const int t = idx / D, d = idx % D;
      const int64_t tok = (static_cast<int64_t>(phys) * T + t) * K + kv;
      const int64_t off = tok * D + d;
      float kx = to_float(pool_k[off]);
      float vx = to_float(pool_v[off]);
      if constexpr (kQ8) {
        kx *= __bfloat162float(pool_ks[tok]);
        vx *= __bfloat162float(pool_vs[tok]);
      }
      k_s[t * kDP + d] = kx;
      v_s[t * kDP + d] = vx;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = warp * kRowsPerWarp + p * kSegs + seg;
      const int row = row0 + r;
      const int qpos = length - q_len + row / G;
      const bool allow = row < valid_end && pg * T + sl <= qpos;
      const float* qr = q_s + r * kDP;
      const float* kr = k_s + sl * kDP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float s = allow ? dot * scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = T / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[p], mx);
      const float pr = s > kNegInf * 0.5f ? expf(s - m_new) : 0.f;
      const float corr = expf(m[p] - m_new);
      float sum = pr;
#pragma unroll
      for (int o = T / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      l[p] = l[p] * corr + sum;
      float pv[kDPL];
#pragma unroll
      for (int j = 0; j < kDPL; ++j) pv[j] = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float pt = __shfl_sync(kFull, pr, seg * T + t);
        if (pt != 0.f) {             // masked slots may hold any garbage
#pragma unroll
          for (int j = 0; j < kDPL; ++j)
            pv[j] = fmaf(pt, v_s[t * kDP + sl + T * j], pv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kDPL; ++j) acc[p][j] = acc[p][j] * corr + pv[j];
      m[p] = m_new;
    }
  }

#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int row = row0 + warp * kRowsPerWarp + p * kSegs + seg;
    if (row >= n_rows) continue;
    const int qi = row / G, h = kv * G + row % G;
    scalar_t* o = out + ((static_cast<int64_t>(b) * Qm + qi) * H + h) * D;
    const bool valid = row < valid_end && length > 0;
    const float denom = fmaxf(l[p], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDPL; ++j)
      store(o + sl + T * j, valid ? acc[p][j] / denom : 0.f);
  }
}

template <typename scalar_t, typename kv_t, int D, int T>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* pool_ks, const void* pool_vs,
                   const void* table, const void* lengths, const void* q_lens,
                   void* out, int L, int B, int Qm, int H, int K, int P,
                   int MP, float scale, cudaStream_t stream) {
  auto kernel = paged_attention_ragged_kernel<scalar_t, kv_t, D, T>;
  const size_t smem = sizeof(float) * (2 * T + kRowsPerBlock) * (D + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = (Qm * (H / K) + kRowsPerBlock - 1) / kRowsPerBlock;
  dim3 grid(tiles, K, L * B);
  const int64_t q_ls = static_cast<int64_t>(B) * Qm * H * D;
  const int64_t scale_ls = static_cast<int64_t>(P) * T * K;
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const kv_t*>(pool_k),
      static_cast<const kv_t*>(pool_v),
      static_cast<const __nv_bfloat16*>(pool_ks),
      static_cast<const __nv_bfloat16*>(pool_vs),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_lens), static_cast<scalar_t*>(out), B, Qm,
      H, K, P, MP, q_ls, scale_ls * D, scale_ls, scale);
  return cudaGetLastError();
}

template <typename scalar_t, typename kv_t>
cudaError_t dispatch(int D, int T, const void* q, const void* pool_k,
                     const void* pool_v, const void* pool_ks,
                     const void* pool_vs, const void* table,
                     const void* lengths, const void* q_lens, void* out,
                     int L, int B, int Qm, int H, int K, int P, int MP,
                     float scale, cudaStream_t stream) {
#define PA_CASE(DD, TT)                                                      \
  if (D == DD && T == TT)                                                    \
    return launch<scalar_t, kv_t, DD, TT>(q, pool_k, pool_v, pool_ks,        \
                                          pool_vs, table, lengths, q_lens,   \
                                          out, L, B, Qm, H, K, P, MP, scale, \
                                          stream);
  PA_CASE(32, 8) PA_CASE(32, 16) PA_CASE(32, 32)
  PA_CASE(64, 8) PA_CASE(64, 16) PA_CASE(64, 32)
  PA_CASE(128, 8) PA_CASE(128, 16) PA_CASE(128, 32)
  PA_CASE(256, 8) PA_CASE(256, 16) PA_CASE(256, 32)
#undef PA_CASE
  return cudaErrorInvalidValue;
}

bool bad_shape(int L, int B, int H, int K, int P, int MP) {
  return K <= 0 || H % K != 0 || P <= 0 || MP <= 0 ||
         static_cast<int64_t>(L) * B > 65535;     // gridDim.z
}

}  // namespace

// q (L, B, Qm, H, D) and out of q's dtype (0 = float32, 1 = bfloat16),
// pools (L, P, T, K, D) of q's type; table (B, MP), lengths and q_lens (B,)
// int32, shared by every layer. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_layers_ragged_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* lengths, const void* q_lens, void* out, int L, int B, int Qm,
    int H, int K, int D, int P, int T, int MP, float scale, int dtype,
    void* stream) {
  if (L <= 0 || B <= 0 || Qm <= 0) return cudaSuccess;
  if (bad_shape(L, B, H, K, P, MP)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, float>(D, T, q, pool_k, pool_v, nullptr, nullptr,
                                  table, lengths, q_lens, out, L, B, Qm, H, K,
                                  P, MP, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        D, T, q, pool_k, pool_v, nullptr, nullptr, table, lengths, q_lens,
        out, L, B, Qm, H, K, P, MP, scale, s);
  return cudaErrorInvalidValue;
}

// The int8 pool: pool_k/pool_v (L, P, T, K, D) int8, pool_ks/pool_vs
// (L, P, T, K) bf16 scales; dtype as above, for q and the output.
extern "C" int paged_attention_layers_ragged_q8_launch(
    const void* q, const void* pool_k, const void* pool_v,
    const void* pool_ks, const void* pool_vs, const void* table,
    const void* lengths, const void* q_lens, void* out, int L, int B, int Qm,
    int H, int K, int D, int P, int T, int MP, float scale, int dtype,
    void* stream) {
  if (L <= 0 || B <= 0 || Qm <= 0) return cudaSuccess;
  if (bad_shape(L, B, H, K, P, MP)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, int8_t>(D, T, q, pool_k, pool_v, pool_ks, pool_vs,
                                   table, lengths, q_lens, out, L, B, Qm, H,
                                   K, P, MP, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, int8_t>(
        D, T, q, pool_k, pool_v, pool_ks, pool_vs, table, lengths, q_lens,
        out, L, B, Qm, H, K, P, MP, scale, s);
  return cudaErrorInvalidValue;
}
