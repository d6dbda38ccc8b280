// Weight-absorbed MLA paged attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel mla_paged_attention_ragged_pallas (body
// _mla_ragged_kernel) of src/repro/kernels/paged_attention/kernel.py, and
// with it the decode entry mla_paged_attention, which the port launches as
// THIS kernel at Qmax = 1 and q_lens = 1 ("ragged at q_len == 1 is bit for
// bit the decode entry" by construction), and the multi-layer entry
// mla_paged_attention_layers_ragged_pallas: the same body over all L layers
// of (L, P, T, dc) / (L, P, T, dr) planes in one launch, one block table and
// one lengths / q_lens shared by every layer. The grid's y axis runs over
// L * B (layer l = y / B, row b = y % B) and each block offsets its query,
// pool and output pointers by 64-bit per-layer strides; a single-layer call
// is L = 1, so layer l of a multi-layer launch is bit for bit the
// single-layer launch on the planes of layer l.
//
// What it computes: DeepSeek-V2's multi-head latent attention after the
// model has absorbed w_uk into the queries. The pool holds, per token, one
// latent c (dc wide) and one rope key kr (dr wide), shared by every head —
// there is no KV-head axis. Query (i, h) of row b, at position
// lengths[b] - q_lens[b] + i, scores key t as (q_c . c_t + q_r . kr_t) *
// scale over the positions at or before it, and returns the
// probability-weighted latent sum_t p_t c_t (B, Qmax, H, dc); the model
// applies w_uv and wo after. Queries and output are fp32 (the model
// computes q_c in fp32), the pool is fp32 or bf16 (the compute dtype, a
// template parameter), the math is fp32. Slots i >= q_lens[b] and
// q_lens[b] == 0 rows are exactly 0.
//
// Bound: operations at prefill chunks, bytes at decode. Every (query, head,
// key) costs 2 * (dc + dr) flop for the score and 2 * dc for the value sum
// (2176 flop at dc 512, dr 64), and H = 128 heads share each page, so a
// Qmax = 128 chunk does ~16k rows of work per page byte; at Qmax = 1 the
// 128 heads still reuse each page 128 times, near the fp32 ridge. This
// simple kernel runs scalar fp32 FMAs on the CUDA cores, not the tensor
// cores, so it sits well above its bound at chunks; a wgmma version is
// later work.
//
// Design (not the TPU block: the TPU kernel keeps all Qmax * H rows'
// dc-wide accumulators resident, 32 MiB at Qmax 128, H 128, dc 512):
//   * one block = one batch row b and a tile of 16 of its Qmax * H
//     (query, head) rows (row r = query i * H + head h, the TPU kernel's
//     order); the rows of a tile share each staged page, so a page is read
//     once per tile and never once per head;
//   * the loop over live pages stops at the tile's last causal position;
//     table[b, p] is clamped into [0, P) and read only for live pages;
//   * a page's [c | kr] (T x (dc + dr)) and the tile's [q_c | q_r] are
//     staged in shared memory as fp32 rows padded by one float;
//   * a row is owned by a segment of T lanes of one warp: lane t scores key
//     t with one sequential fp32 dot over the dc + dr features, the segment
//     reduces max and sum with xor butterflies, and lane t owns latent
//     features t, t + T, ... of the output (16 rows x dc fp32 = 32 KB of
//     accumulator per block at dc 512, in registers); the online softmax
//     follows kernel.py's rules (running max from -1e30, masked
//     probabilities forced to 0 and multiplying nothing, finish divides by
//     max(l, 1e-30)).
// A row's arithmetic does not depend on its tile, on Qmax or on the rows
// around it, and a fully masked page leaves its state bitwise unchanged,
// so the tile-dependent page bound changes no bit. No split of the pages
// across blocks, no atomic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename pool_t, int DC, int T>
__global__ void __launch_bounds__(kWarps * 32)
mla_paged_attention_ragged_kernel(const float* __restrict__ q_c,
                                  const float* __restrict__ q_r,
                                  const pool_t* __restrict__ pool_c,
                                  const pool_t* __restrict__ pool_kr,
                                  const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ q_lens,
                                  float* __restrict__ out, int B, int Qm,
                                  int H, int DR, int P, int MP,
                                  int64_t pool_ls, float scale) {
  constexpr int kSegs = 32 / T;                  // rows a warp runs at once
  constexpr int kPasses = kRowsPerWarp / kSegs;
  constexpr int kDPL = DC / T;                   // latent features per lane
  static_assert(32 % T == 0 && kRowsPerWarp % kSegs == 0, "page size");
  static_assert(DC % T == 0, "latent width");
  const int W = DC + DR;                         // score features
  const int kDP = W + 1;                         // padded smem row

  extern __shared__ float smem[];
  float* kv_s = smem;                            // (T, kDP): [c | kr]
  float* q_s = kv_s + T * kDP;                   // (kRowsPerBlock, kDP)

  const int layer = blockIdx.y / B, b = blockIdx.y % B;
  const int n_rows = Qm * H;
  const int64_t rows_ls = static_cast<int64_t>(B) * n_rows;  // per layer
  q_c += layer * rows_ls * DC;
  out += layer * rows_ls * DC;
  q_r += layer * rows_ls * DR;
  pool_c += layer * pool_ls * DC;
  pool_kr += layer * pool_ls * DR;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int length = lengths[b];
  const int q_len = q_lens[b];
  const int valid_end = min(n_rows, max(q_len, 0) * H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane / T, sl = lane % T;

  int n_pages = 0;
  if (row0 < valid_end) {
    const int r_last = min(row0 + kRowsPerBlock, valid_end) - 1;
    const int pos_last = length - q_len + r_last / H;
    n_pages = pos_last >= 0 ? min(pos_last / T + 1, MP) : 0;
  }

  for (int idx = threadIdx.x; idx < kRowsPerBlock * W; idx += blockDim.x) {
    const int r = idx / W, d = idx % W;
    const int row = row0 + r;
    float x = 0.f;
    if (row < valid_end) {
      const int64_t qh = static_cast<int64_t>(b) * n_rows + row;  // (b,i,h)
      x = d < DC ? q_c[qh * DC + d] : q_r[qh * DR + (d - DC)];
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
    for (int idx = threadIdx.x; idx < T * W; idx += blockDim.x) {
      const int t = idx / W, d = idx % W;
      const int64_t tok = static_cast<int64_t>(phys) * T + t;
      kv_s[t * kDP + d] = to_float(d < DC ? pool_c[tok * DC + d]
                                          : pool_kr[tok * DR + (d - DC)]);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = warp * kRowsPerWarp + p * kSegs + seg;
      const int row = row0 + r;
      const int qpos = length - q_len + row / H;
      const bool allow = row < valid_end && pg * T + sl <= qpos;
      const float* qr = q_s + r * kDP;
      const float* kr = kv_s + sl * kDP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < W; ++d) dot = fmaf(qr[d], kr[d], dot);
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
            pv[j] = fmaf(pt, kv_s[t * kDP + sl + T * j], pv[j]);
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
    float* o = out + (static_cast<int64_t>(b) * n_rows + row) * DC;
    const bool valid = row < valid_end && length > 0;
    const float denom = fmaxf(l[p], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDPL; ++j)
      o[sl + T * j] = valid ? acc[p][j] / denom : 0.f;
  }
}

template <typename pool_t, int DC, int T>
cudaError_t launch(const void* q_c, const void* q_r, const void* pool_c,
                   const void* pool_kr, const void* table,
                   const void* lengths, const void* q_lens, void* out, int L,
                   int B, int Qm, int H, int DR, int P, int MP, float scale,
                   cudaStream_t stream) {
  auto kernel = mla_paged_attention_ragged_kernel<pool_t, DC, T>;
  const size_t smem =
      sizeof(float) * (T + kRowsPerBlock) * (DC + DR + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = (Qm * H + kRowsPerBlock - 1) / kRowsPerBlock;
  dim3 grid(tiles, L * B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q_c), static_cast<const float*>(q_r),
      static_cast<const pool_t*>(pool_c), static_cast<const pool_t*>(pool_kr),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_lens), static_cast<float*>(out), B, Qm, H,
      DR, P, MP, static_cast<int64_t>(P) * T, scale);
  return cudaGetLastError();
}

template <typename pool_t>
cudaError_t dispatch(int DC, int T, const void* q_c, const void* q_r,
                     const void* pool_c, const void* pool_kr,
                     const void* table, const void* lengths,
                     const void* q_lens, void* out, int L, int B, int Qm,
                     int H, int DR, int P, int MP, float scale,
                     cudaStream_t stream) {
#define MLA_CASE(CC, TT)                                                    \
  if (DC == CC && T == TT)                                                  \
    return launch<pool_t, CC, TT>(q_c, q_r, pool_c, pool_kr, table,         \
                                  lengths, q_lens, out, L, B, Qm, H, DR, P,  \
                                  MP, scale, stream);
  MLA_CASE(32, 8) MLA_CASE(32, 16) MLA_CASE(32, 32)
  MLA_CASE(64, 8) MLA_CASE(64, 16) MLA_CASE(64, 32)
  MLA_CASE(128, 8) MLA_CASE(128, 16) MLA_CASE(128, 32)
  MLA_CASE(256, 8) MLA_CASE(256, 16) MLA_CASE(256, 32)
  MLA_CASE(512, 8) MLA_CASE(512, 16) MLA_CASE(512, 32)
#undef MLA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q_c (L, B, Qm, H, DC) and q_r (L, B, Qm, H, DR) fp32; pool_c
// (L, P, T, DC) and pool_kr (L, P, T, DR) of pool_dtype (0 = float32,
// 1 = bfloat16); table (B, MP), lengths and q_lens (B,) int32, shared by
// every layer; out (L, B, Qm, H, DC) fp32. Returns a cudaError_t
// (0 = launched).
extern "C" int mla_paged_attention_layers_ragged_launch(
    const void* q_c, const void* q_r, const void* pool_c, const void* pool_kr,
    const void* table, const void* lengths, const void* q_lens, void* out,
    int L, int B, int Qm, int H, int DC, int DR, int P, int T, int MP,
    float scale, int pool_dtype, void* stream) {
  if (L <= 0 || B <= 0 || Qm <= 0) return cudaSuccess;
  if (H <= 0 || DR <= 0 || P <= 0 || MP <= 0 ||
      static_cast<int64_t>(L) * B > 65535)          // gridDim.y
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 0)
    return dispatch<float>(DC, T, q_c, q_r, pool_c, pool_kr, table, lengths,
                           q_lens, out, L, B, Qm, H, DR, P, MP, scale, s);
  if (pool_dtype == 1)
    return dispatch<__nv_bfloat16>(DC, T, q_c, q_r, pool_c, pool_kr, table,
                                   lengths, q_lens, out, L, B, Qm, H, DR, P,
                                   MP, scale, s);
  return cudaErrorInvalidValue;
}
