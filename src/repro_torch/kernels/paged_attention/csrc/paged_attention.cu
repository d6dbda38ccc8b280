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
// live page once per row tile, keep many pages in flight, and touch no dead
// page. (fp32 inputs at long chunks sit near the ~20 flop/byte ridge of fp32
// outside the tensor cores.) The int8 layout halves the page bytes (2 * D + 4
// bytes per token and KV head against 4 * D in bf16); its pages are read as
// int8 and dequantized in shared memory, never materialized in HBM.
//
// Design: split-KV over fixed partitions of pages, two kernels a call.
//   * paged_attention_part_kernel: one block = one (layer, b, kv head), a
//     tile of 32 of the Qmax*G query rows (row r = query i * G + group g,
//     the TPU kernel's QG order) and one PARTITION of the tile's pages:
//     pages [8 p, 8 p + 8). kPagesPerPart is a compile-time constant, never
//     derived from the card, B, Qmax or the lengths. The tile's page count
//     stops at its last valid query's causal position (early tiles of a
//     chunk never load pages only later queries see); partitions past it
//     exit at once. A decode row of 64 pages becomes 8 blocks walking 8
//     pages each, where one block walked all 64;
//   * table[b, p] is read in the block and clamped into [0, P); entries past
//     the live pages are never read, so dead table tails can hold anything;
//   * page n + 1's K and V rows for the head are fetched with 16-byte
//     cp.async (int8: 16 codes a copy; its bf16 scales by plain loads into
//     registers, a page ahead) while page n is scored (a deeper ring of
//     raw buffers costs more in occupancy than it hides); a page is then
//     converted once into fp32 rows padded to D + 4 floats in shared memory
//     (int8: float(code) * float(scale), one rounded product stored before
//     any FMA, the JAX body's order);
//   * each warp owns 8 rows of the tile and computes the page for all of
//     them at once, so a K or V element read from shared memory serves 8
//     rows: lane (key t, dpart) dots float4 chunks dpart, dpart + 32 / T,
//     ... of the 8 query rows with key t into two fp32 partial sums (x, z
//     and y, w), so an output is 2 * 32 / T independent chains over D,
//     added in one fixed order (the pair, then across dparts with xor
//     butterflies); the T keys' lanes reduce max and
//     sum with xor butterflies; the probabilities go through shared memory
//     to P.V, where lane l owns output features 4 l .. 4 l + 3 (+ 128) of
//     the 8 rows. The online softmax follows kernel.py's rules: running
//     max from -1e30, masked probabilities forced to 0, P.V over the
//     page's slots below `length` only (a dead slot's value, int8 * 1e6
//     scale included, is never read; a causally masked live slot adds
//     0 * a finite value). A warp whose rows are all padding skips the
//     page compute. Registers bound the occupancy: __launch_bounds__(128,
//     4) with the rows' causal positions in shared memory keeps the main
//     instantiations at 128 registers without spills;
//   * each block writes its rows' partition state (m, l, acc) to fp32
//     scratch that the caller allocates (paged_attention_scratch_floats).
//     The scratch is capped at kScratchCapFloats: a launch whose (layer, b,
//     kv head, row, partition) entries need more runs the two kernels in
//     passes over slices of (layer, b) and then of row tiles, each pass
//     reusing the scratch. A pass computes its rows exactly as one launch
//     would, so the passes change no bit;
//   * paged_attention_combine_kernel: one warp = one row; it compacts the
//     tile's partitions whose l is not 0 into shared memory in ascending
//     order (a ballot; a partition the row sees no key of is SKIPPED, not
//     added with weight 0), then merges them in that order through one
//     code path, with every load independent of the running sums, and
//     divides by max(l, 1e-30); padding slots, q_len == 0 and lengths == 0
//     rows are written 0.
// Bitwise pins, by construction: a page fully masked for a row leaves its
// partition state unchanged (corr == exp(0) == 1, every probability 0, and
// an accumulator that starts at +0 never becomes -0, so adding 0 * v to it
// changes no bit); a
// partition fully masked for a row is skipped by the combine, and a row with
// one live partition comes out as acc * 1 / max(l * 1, 1e-30), the same bits
// whatever other partitions its tile has. So a row's result depends only on
// its own keys and the fixed partition boundaries: q_len == 1 ragged is the
// decode launch, layer l of a multi-layer launch is the single-layer launch,
// and committing one more slot reproduces the earlier launch as a prefix.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kPagesPerPart = 8;
// fp32 elements of split-KV scratch a launch may use (128 MiB)
constexpr int64_t kScratchCapFloats = int64_t{1} << 25;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// four consecutive elements of a staged page row as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<signed char>(c.x),
                     static_cast<signed char>(c.y),
                     static_cast<signed char>(c.z),
                     static_cast<signed char>(c.w));
}

// The pages a row tile needs: up to its last valid query's causal position
// (0 for a tile of padding rows). Both kernels call it.
__device__ __forceinline__ int tile_pages(int row0, int valid_end,
                                          int length, int q_len, int G,
                                          int T, int MP) {
  if (row0 >= valid_end) return 0;
  const int r_last = min(row0 + kRowsPerBlock, valid_end) - 1;
  const int pos_last = length - q_len + r_last / G;
  return pos_last >= 0 ? min(pos_last / T + 1, MP) : 0;
}

// Output feature f of lane `lane` (f < D / 32): the part kernel's P.V layout
template <int D>
__device__ __forceinline__ int feature_of(int lane, int f) {
  return D >= 128 ? (f / 4) * 128 + lane * 4 + f % 4 : lane * (D / 32) + f;
}

// kv_t is scalar_t (dense pool) or int8_t (pool_ks/pool_vs then hold the
// bf16 per-(token, head) scales; unused and null for a dense pool)
template <typename scalar_t, typename kv_t, int D, int T>
__global__ void __launch_bounds__(kWarps * 32, 4)
paged_attention_part_kernel(const scalar_t* __restrict__ q,
                            const kv_t* __restrict__ pool_k,
                            const kv_t* __restrict__ pool_v,
                            const __nv_bfloat16* __restrict__ pool_ks,
                            const __nv_bfloat16* __restrict__ pool_vs,
                            const int32_t* __restrict__ table,
                            const int32_t* __restrict__ lengths,
                            const int32_t* __restrict__ q_lens,
                            float* __restrict__ part_ml,
                            float* __restrict__ part_acc, int B, int Qm,
                            int H, int K, int P, int MP, int n_parts, int z0,
                            int t0, int pass_rows, int64_t q_ls,
                            int64_t pool_ls, int64_t scale_ls, float scale) {
  constexpr int kRW = kRowsPerWarp;
  constexpr int kDSplit = 32 / T;                // lanes sharing one key
  constexpr int kC = D / 4 / kDSplit;            // float4 chunks a lane dots
  constexpr int kF = D / 32;                     // output features a lane
  constexpr int kKP = D + 4;                     // padded fp32 page row
  constexpr int kRowBytes = D * static_cast<int>(sizeof(kv_t));
  constexpr int kChunks = kRowBytes / 16;        // cp.async copies a row

  static_assert(32 % T == 0 && D % 32 == 0 && kRowBytes % 16 == 0,
                "page size or head dim");
  static_assert(kRW == 8, "two float4 of probabilities a key");
  constexpr bool kQ8 = std::is_same<kv_t, int8_t>::value;

  extern __shared__ __align__(16) unsigned char pa_smem[];
  unsigned char* raw = pa_smem;                  // (2, T, kRowBytes) codes
  float* q_s = reinterpret_cast<float*>(raw + 2 * T * kRowBytes);  // (R, D)
  float* k_s = q_s + kRowsPerBlock * D;          // (T, kKP)
  float* v_s = k_s + T * kKP;                    // (T, kKP)
  float* p_s = v_s + T * kKP;                    // (warps, T, kRW)
  float* sc_s = p_s + kWarps * T * kRW;          // (2, T) int8 scales

  const int tile = t0 + blockIdx.x / n_parts, part = blockIdx.x % n_parts;
  const int kv = blockIdx.y;
  const int z = z0 + blockIdx.z, layer = z / B, b = z % B;
  const int G = H / K;
  const int n_rows = Qm * G;
  const int row0 = tile * kRowsPerBlock;
  const int length = lengths[b];
  const int q_len = q_lens[b];
  const int valid_end = min(n_rows, max(q_len, 0) * G);
  const int n_pages = tile_pages(row0, valid_end, length, q_len, G, T, MP);
  const int pg0 = part * kPagesPerPart;
  if (pg0 >= n_pages) return;                    // past the tile's pages
  const int pg_end = min(pg0 + kPagesPerPart, n_pages);
  q += layer * q_ls;
  pool_k += layer * pool_ls;
  pool_v += layer * pool_ls;
  if constexpr (kQ8) {
    pool_ks += layer * scale_ls;
    pool_vs += layer * scale_ls;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = lane % T, dpart = lane / T;
  // this warp's rows: r0 .. r0 + n_valid - 1 of the tile are valid
  const int r0 = warp * kRW;
  const int n_valid = min(max(valid_end - row0 - r0, 0), kRW);

  auto phys_page = [&](int pg) {
    return min(max(table[static_cast<int64_t>(b) * MP + pg], 0), P - 1);
  };
  // the partition's pages, read once (visible after the loop's first sync)
  int* pg_s = reinterpret_cast<int*>(sc_s + 2 * T);
  if (threadIdx.x < pg_end - pg0)
    pg_s[threadIdx.x] = phys_page(pg0 + threadIdx.x);
  auto fetch = [&](int phys) {     // page phys's K and V rows of head kv
    const int64_t tok0 = static_cast<int64_t>(phys) * T * K + kv;
    for (int idx = threadIdx.x; idx < 2 * T * kChunks; idx += blockDim.x) {
      const int plane = idx / (T * kChunks), t = idx / kChunks % T;
      const int c = idx % kChunks;
      const kv_t* src = (plane ? pool_v : pool_k) + (tok0 + t * K) * D;
      cp_async16(raw + (plane * T + t) * kRowBytes + c * 16,
                 reinterpret_cast<const unsigned char*>(src) + c * 16);
    }
    cp_async_commit();
  };
  // int8: thread i < 2T holds the scale of token i % T of plane i / T,
  // loaded a page ahead
  auto fetch_scale = [&](int phys) {
    float x = 0.f;
    if constexpr (kQ8) {
      if (threadIdx.x < 2 * T) {
        const int t = threadIdx.x % T;
        const int64_t tok = (static_cast<int64_t>(phys) * T + t) * K + kv;
        x = __bfloat162float(threadIdx.x < T ? pool_ks[tok] : pool_vs[tok]);
      }
    }
    return x;
  };

  const int phys0 = phys_page(pg0);
  fetch(phys0);
  float sc = fetch_scale(phys0);
  for (int u = threadIdx.x; u < kRowsPerBlock * D / 4; u += blockDim.x) {
    const int r = u / (D / 4), d = u % (D / 4) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < valid_end) {
      const int qi = row / G, h = kv * G + row % G;
      x = load4(q + ((static_cast<int64_t>(b) * Qm + qi) * H + h) * D + d);
    }
    *reinterpret_cast<float4*>(q_s + r * D + d) = x;
  }

  // per row i of the warp (replicated in every lane): running max and sum;
  // acc[i][f]: output feature feature_of<D>(lane, f)
  float m[kRW], l[kRW], acc[kRW][kF];
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int f = 0; f < kF; ++f) acc[i][f] = 0.f;
  }
  // each row's causal position, kept in shared memory (registers are
  // the scarce resource here)
  int* qpos_s = pg_s + kPagesPerPart;
  if (threadIdx.x < kRowsPerBlock)
    qpos_s[threadIdx.x] = length - q_len + (row0 + threadIdx.x) / G;
  float* pw = p_s + warp * T * kRW;

  for (int pg = pg0; pg < pg_end; ++pg) {
    if (kQ8 && threadIdx.x < 2 * T) sc_s[threadIdx.x] = sc;
    cp_async_wait_all();
    __syncthreads();                 // page pg landed; page pg - 1 done
    for (int u = threadIdx.x; u < 2 * T * D / 4; u += blockDim.x) {
      const int plane = u / (T * D / 4), t = u / (D / 4) % T;
      const int d = u % (D / 4) * 4;
      float4 x = load4(reinterpret_cast<const kv_t*>(
                           raw + (plane * T + t) * kRowBytes) + d);
      if constexpr (kQ8) {
        const float s = sc_s[plane * T + t];
        x = make_float4(__fmul_rn(x.x, s), __fmul_rn(x.y, s),
                        __fmul_rn(x.z, s), __fmul_rn(x.w, s));
      }
      *reinterpret_cast<float4*>((plane ? v_s : k_s) + t * kKP + d) = x;
    }
    __syncthreads();                 // fp32 page visible; codes consumed
    if (pg + 1 < pg_end) {
      fetch(pg_s[pg + 1 - pg0]);
      sc = fetch_scale(pg_s[pg + 1 - pg0]);
    }
    if (n_valid == 0) continue;      // warp-uniform: no row of this warp

    // scores: lane (key, dpart) dots chunks dpart, dpart + kDSplit, ... of
    // the warp's rows with key `key` into two partial sums (float4 lanes
    // x, z and y, w), then adds the pair and the dparts with xor
    // butterflies (one fixed order)
    float dot[kRW][2];
#pragma unroll
    for (int i = 0; i < kRW; ++i) dot[i][0] = dot[i][1] = 0.f;
    const float* kr = k_s + key * kKP;
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const int d = (c * kDSplit + dpart) * 4;
      const float4 kx = load4(kr + d);
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        if (i < n_valid) {
          const float4 qx = load4(q_s + (r0 + i) * D + d);
          dot[i][0] = fmaf(qx.z, kx.z, fmaf(qx.x, kx.x, dot[i][0]));
          dot[i][1] = fmaf(qx.w, kx.w, fmaf(qx.y, kx.y, dot[i][1]));
        }
      }
    }
    const bool live_key = pg * T + key < length;
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      if (i >= n_valid) break;
      float sd = dot[i][0] + dot[i][1];
#pragma unroll
      for (int o = T; o < 32; o <<= 1) sd += __shfl_xor_sync(kFull, sd, o);
      const float s = live_key && pg * T + key <= qpos_s[r0 + i]
                          ? sd * scale
                          : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = T / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float pr = s > kNegInf * 0.5f ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      float sum = pr;
#pragma unroll
      for (int o = T / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int f = 0; f < kF; ++f) acc[i][f] *= corr;
      if (dpart == 0) pw[key * kRW + i] = pr;
    }
    __syncwarp();
    // P.V over the page's live keys (a dead slot's value is never read; a
    // masked live key adds p = 0 times a finite value)
    const int n_keys = min(T, length - pg * T);
    for (int t = 0; t < n_keys; ++t) {
      const float4 pa = load4(pw + t * kRW), pb = load4(pw + t * kRW + 4);
      const float pt[kRW] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vx[kF];
#pragma unroll
      for (int g = 0; g < kF / 4; ++g) {
        const float4 x = load4(v_s + t * kKP + g * 128 + lane * 4);
        vx[4 * g] = x.x;
        vx[4 * g + 1] = x.y;
        vx[4 * g + 2] = x.z;
        vx[4 * g + 3] = x.w;
      }
      if constexpr (kF < 4) {
#pragma unroll
        for (int f = 0; f < kF; ++f) vx[f] = v_s[t * kKP + lane * kF + f];
      }
#pragma unroll
      for (int i = 0; i < kRW; ++i)
        if (i < n_valid)
#pragma unroll
          for (int f = 0; f < kF; ++f)
            acc[i][f] = fmaf(pt[i], vx[f], acc[i][f]);
    }
    __syncwarp();                    // pw is rewritten by the next page
  }

  // this partition's state of each valid row, at the pass's entry
  // ((z - z0) * K + kv, row - t0 * R, part)
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    if (i >= n_valid) break;
    const int row = row0 + r0 + i;
    const int64_t at =
        ((static_cast<int64_t>(blockIdx.z) * K + kv) * pass_rows + row -
         t0 * kRowsPerBlock) * n_parts + part;
    if (lane == 0) {
      part_ml[2 * at] = m[i];
      part_ml[2 * at + 1] = l[i];
    }
    float* a = part_acc + at * D;
#pragma unroll
    for (int f = 0; f < kF; ++f) a[feature_of<D>(lane, f)] = acc[i][f];
  }
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_combine_kernel(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               const int32_t* __restrict__ lengths,
                               const int32_t* __restrict__ q_lens,
                               scalar_t* __restrict__ out, int B, int Qm,
                               int H, int K, int T, int MP, int n_parts,
                               int z0, int t0, int pass_rows, int64_t q_ls) {
  constexpr int kF = D / 32;                     // output features a lane
  constexpr int kGroups = kRowsPerBlock / kWarps;
  extern __shared__ __align__(16) unsigned char cb_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp's live partitions, ascending: index, weight, l
  int* idx_s = reinterpret_cast<int*>(cb_smem) + warp * n_parts;
  float* w_s = reinterpret_cast<float*>(cb_smem) + (kWarps + warp) * n_parts;
  float* l_s =
      reinterpret_cast<float*>(cb_smem) + (2 * kWarps + warp) * n_parts;

  const int tile = t0 + blockIdx.x / kGroups;
  const int kv = blockIdx.y;
  const int z = z0 + blockIdx.z, layer = z / B, b = z % B;
  const int G = H / K;
  const int n_rows = Qm * G;
  const int row0 = tile * kRowsPerBlock;
  const int row = row0 + (blockIdx.x % kGroups) * kWarps + warp;
  if (row >= n_rows) return;
  const int length = lengths[b];
  const int q_len = q_lens[b];
  const int valid_end = min(n_rows, max(q_len, 0) * G);
  const int qi = row / G, h = kv * G + row % G;
  scalar_t* o = out + layer * q_ls +
                ((static_cast<int64_t>(b) * Qm + qi) * H + h) * D;
  if (row >= valid_end || length <= 0) {
#pragma unroll
    for (int f = 0; f < kF; ++f) store(o + feature_of<D>(lane, f), 0.f);
    return;
  }
  const int n_live = (tile_pages(row0, valid_end, length, q_len, G, T, MP) +
                      kPagesPerPart - 1) / kPagesPerPart;
  const int64_t at0 = ((static_cast<int64_t>(blockIdx.z) * K + kv) *
                           pass_rows + row - t0 * kRowsPerBlock) * n_parts;

  // the largest running max over the partitions that saw a key (a max is
  // exact in any order)
  float mx = kNegInf;
  for (int p = lane; p < n_live; p += 32)
    if (part_ml[2 * (at0 + p) + 1] != 0.f)
      mx = fmaxf(mx, part_ml[2 * (at0 + p)]);
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o2));
  // the partitions with l != 0, in ascending order (one with l == 0 saw
  // no key of this row and is skipped, not added with weight 0)
  int n_lp = 0;
  for (int base = 0; base < n_live; base += 32) {
    const int p = base + lane;
    const float lp = p < n_live ? part_ml[2 * (at0 + p) + 1] : 0.f;
    const bool live = lp != 0.f;
    const unsigned ballot = __ballot_sync(kFull, live);
    if (live) {
      const int j = n_lp + __popc(ballot & ((1u << lane) - 1u));
      idx_s[j] = p;
      w_s[j] = expf(part_ml[2 * (at0 + p)] - mx);
      l_s[j] = lp;
    }
    n_lp += __popc(ballot);
  }
  __syncwarp();
  float den = 0.f, num[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) num[f] = 0.f;
#pragma unroll 4
  for (int j = 0; j < n_lp; ++j) {
    const float w = w_s[j];
    const float* a = part_acc + (at0 + idx_s[j]) * D;
    den = j == 0 ? l_s[j] * w : fmaf(l_s[j], w, den);
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const float x = a[feature_of<D>(lane, f)];
      num[f] = j == 0 ? x * w : fmaf(x, w, num[f]);
    }
  }
  const float denom = fmaxf(den, 1e-30f);
#pragma unroll
  for (int f = 0; f < kF; ++f)
    store(o + feature_of<D>(lane, f), num[f] / denom);
}

// How a launch's split-KV work is cut into passes that fit the scratch:
// slices of zc (layer, b) pairs, each over all row tiles, or, where one
// (layer, b) pair alone needs more than the cap, one pair at a time in
// slices of tc row tiles. Scratch entries are (pair, kv head, row,
// partition) of the pass's real rows (padding rows of the last tile take
// none); each holds (m, l) and a D-wide accumulator.
struct Plan {
  int n_rows, n_parts, n_tiles, zc, tc;
  int64_t pass_rows(int t0) const {
    return std::min(n_rows, (t0 + tc) * kRowsPerBlock) - t0 * kRowsPerBlock;
  }
  int64_t floats(int nz, int K, int t0, int D) const {
    return static_cast<int64_t>(nz) * K * pass_rows(t0) * n_parts * (D + 2);
  }
};

Plan plan_of(int L, int B, int Qm, int H, int K, int D, int MP) {
  Plan p;
  p.n_rows = Qm * (H / K);
  p.n_parts = (MP + kPagesPerPart - 1) / kPagesPerPart;
  p.n_tiles = (p.n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t pair = static_cast<int64_t>(K) * p.n_rows * p.n_parts *
                       (D + 2);
  if (pair <= kScratchCapFloats) {
    p.zc = static_cast<int>(
        std::min(static_cast<int64_t>(L) * B, kScratchCapFloats / pair));
    p.tc = p.n_tiles;
  } else {
    const int64_t tile = static_cast<int64_t>(K) * kRowsPerBlock *
                         p.n_parts * (D + 2);
    p.zc = 1;
    p.tc = static_cast<int>(std::max(int64_t{1}, kScratchCapFloats / tile));
  }
  return p;
}

template <typename scalar_t, typename kv_t, int D, int T>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* pool_ks, const void* pool_vs,
                   const void* table, const void* lengths, const void* q_lens,
                   void* out, void* scratch, int L, int B, int Qm, int H,
                   int K, int P, int MP, float scale, cudaStream_t stream) {
  auto kernel = paged_attention_part_kernel<scalar_t, kv_t, D, T>;
  const size_t smem = 2 * T * D * sizeof(kv_t) +
                      sizeof(float) * (kRowsPerBlock * D + 2 * T * (D + 4) +
                                       kWarps * T * kRowsPerWarp + 2 * T) +
                      sizeof(int) * (kPagesPerPart + kRowsPerBlock);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const Plan pl = plan_of(L, B, Qm, H, K, D, MP);
  const int n_parts = pl.n_parts;
  if (static_cast<int64_t>(pl.tc) * n_parts > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int64_t q_ls = static_cast<int64_t>(B) * Qm * H * D;
  const int64_t scale_ls = static_cast<int64_t>(P) * T * K;
  auto combine = paged_attention_combine_kernel<scalar_t, D>;
  const size_t smem2 = 3 * sizeof(float) * kWarps * n_parts;
  if (smem2 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        combine, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem2));
    if (err != cudaSuccess) return err;
  }
  for (int z0 = 0; z0 < L * B; z0 += pl.zc) {
    const int nz = std::min(pl.zc, L * B - z0);
    for (int t0 = 0; t0 < pl.n_tiles; t0 += pl.tc) {
      const int nt = std::min(pl.tc, pl.n_tiles - t0);
      const int rows = static_cast<int>(pl.pass_rows(t0));
      float* part_ml = static_cast<float*>(scratch);
      float* part_acc = part_ml + 2 * (pl.floats(nz, K, t0, D) / (D + 2));
      dim3 grid(static_cast<unsigned>(nt * n_parts), K, nz);
      kernel<<<grid, kWarps * 32, smem, stream>>>(
          static_cast<const scalar_t*>(q), static_cast<const kv_t*>(pool_k),
          static_cast<const kv_t*>(pool_v),
          static_cast<const __nv_bfloat16*>(pool_ks),
          static_cast<const __nv_bfloat16*>(pool_vs),
          static_cast<const int32_t*>(table),
          static_cast<const int32_t*>(lengths),
          static_cast<const int32_t*>(q_lens), part_ml, part_acc, B, Qm, H,
          K, P, MP, n_parts, z0, t0, rows, q_ls, scale_ls * D, scale_ls,
          scale);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      dim3 grid2(static_cast<unsigned>(nt * (kRowsPerBlock / kWarps)), K,
                 nz);
      combine<<<grid2, kWarps * 32, smem2, stream>>>(
          part_ml, part_acc, static_cast<const int32_t*>(lengths),
          static_cast<const int32_t*>(q_lens), static_cast<scalar_t*>(out),
          B, Qm, H, K, T, MP, n_parts, z0, t0, rows, q_ls);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <typename scalar_t, typename kv_t>
cudaError_t dispatch(int D, int T, const void* q, const void* pool_k,
                     const void* pool_v, const void* pool_ks,
                     const void* pool_vs, const void* table,
                     const void* lengths, const void* q_lens, void* out,
                     void* scratch, int L, int B, int Qm, int H, int K, int P,
                     int MP, float scale, cudaStream_t stream) {
#define PA_CASE(DD, TT)                                                      \
  if (D == DD && T == TT)                                                    \
    return launch<scalar_t, kv_t, DD, TT>(q, pool_k, pool_v, pool_ks,        \
                                          pool_vs, table, lengths, q_lens,   \
                                          out, scratch, L, B, Qm, H, K, P,   \
                                          MP, scale, stream);
  PA_CASE(32, 8) PA_CASE(32, 16) PA_CASE(32, 32)
  PA_CASE(64, 8) PA_CASE(64, 16) PA_CASE(64, 32)
  PA_CASE(128, 8) PA_CASE(128, 16) PA_CASE(128, 32)
  PA_CASE(256, 8) PA_CASE(256, 16) PA_CASE(256, 32)
#undef PA_CASE
  return cudaErrorInvalidValue;
}

bool bad_shape(int L, int B, int H, int K, int P, int MP) {
  return K <= 0 || H % K != 0 || P <= 0 || MP <= 0 || K > 65535 ||
         static_cast<int64_t>(L) * B > 65535;     // gridDim.y, gridDim.z
}

}  // namespace

// fp32 elements of the scratch a launch of these shapes needs: its largest
// pass's (m, l) and D-wide accumulator for each (layer, b, kv head, row,
// partition); at most kScratchCapFloats unless one row tile of one (layer,
// b) pair alone needs more.
extern "C" int64_t paged_attention_scratch_floats(int L, int B, int Qm,
                                                  int H, int K, int D,
                                                  int MP) {
  if (L <= 0 || B <= 0 || Qm <= 0 || K <= 0 || H % K != 0 || MP <= 0)
    return 0;
  const Plan pl = plan_of(L, B, Qm, H, K, D, MP);
  return pl.floats(pl.zc, K, 0, D);     // the first pass is the largest
}

// The pages of one split-KV partition (a compile-time constant).
extern "C" int paged_attention_pages_per_part() { return kPagesPerPart; }

// q (L, B, Qm, H, D) and out of q's dtype (0 = float32, 1 = bfloat16),
// pools (L, P, T, K, D) of q's type; table (B, MP), lengths and q_lens (B,)
// int32, shared by every layer; scratch of paged_attention_scratch_floats
// fp32. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_layers_ragged_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* lengths, const void* q_lens, void* out, void* scratch, int L,
    int B, int Qm, int H, int K, int D, int P, int T, int MP, float scale,
    int dtype, void* stream) {
  if (L <= 0 || B <= 0 || Qm <= 0) return cudaSuccess;
  if (bad_shape(L, B, H, K, P, MP)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, float>(D, T, q, pool_k, pool_v, nullptr, nullptr,
                                  table, lengths, q_lens, out, scratch, L, B,
                                  Qm, H, K, P, MP, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        D, T, q, pool_k, pool_v, nullptr, nullptr, table, lengths, q_lens,
        out, scratch, L, B, Qm, H, K, P, MP, scale, s);
  return cudaErrorInvalidValue;
}

// The int8 pool: pool_k/pool_v (L, P, T, K, D) int8, pool_ks/pool_vs
// (L, P, T, K) bf16 scales; dtype as above, for q and the output.
extern "C" int paged_attention_layers_ragged_q8_launch(
    const void* q, const void* pool_k, const void* pool_v,
    const void* pool_ks, const void* pool_vs, const void* table,
    const void* lengths, const void* q_lens, void* out, void* scratch, int L,
    int B, int Qm, int H, int K, int D, int P, int T, int MP, float scale,
    int dtype, void* stream) {
  if (L <= 0 || B <= 0 || Qm <= 0) return cudaSuccess;
  if (bad_shape(L, B, H, K, P, MP)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, int8_t>(D, T, q, pool_k, pool_v, pool_ks, pool_vs,
                                   table, lengths, q_lens, out, scratch, L, B,
                                   Qm, H, K, P, MP, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, int8_t>(
        D, T, q, pool_k, pool_v, pool_ks, pool_vs, table, lengths, q_lens,
        out, scratch, L, B, Qm, H, K, P, MP, scale, s);
  return cudaErrorInvalidValue;
}
