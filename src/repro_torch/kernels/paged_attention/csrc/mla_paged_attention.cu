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
// template parameter), every sum is fp32. Slots i >= q_lens[b] and
// q_lens[b] == 0 rows are exactly 0.
//
// Bound on this card: bytes, once the products run on the tensor cores.
// All H = 128 heads share each latent page, so per row b the work is two
// matrix products of the textbook shape: S = [q_c | q_r] . [c | kr]^T
// (Qmax * H query rows against the keys, depth dc + dr = 576) and P . C
// (depth T, width dc = 512), 2176 flop per (query, head, key). At the
// serving shapes (B 8, 64-page table) that is 3.49e10 flop against 574 MB
// at Qmax 128 (0.035 ms at the bf16 tensor-core rate, 0.171 ms of bytes)
// and 5.9e8 flop against 7.0 MB at Qmax 1 (0.0006 against 0.0021 ms). On
// the CUDA cores (67 TFLOP/s fp32) the same flop take 0.52 ms: scalar
// FMAs cannot reach the bytes bound.
//
// Design (not the TPU block: the TPU kernel keeps all Qmax * H rows'
// dc-wide accumulators resident, 32 MiB at Qmax 128, H 128, dc 512):
//   * mla_paged_attention_part_kernel: one block (8 warps) = one (layer,
//     b) and a tile of 64 (query, head) rows (row r = query i * H + head h,
//     the TPU kernel's order). Warp w owns rows 16 (w % 4) .. + 16 and the
//     latent half w / 4 of the output: a 16 x dc/2 fp32 accumulator in
//     mma fragments (128 registers a thread at dc 512). The 64-row query
//     tile (two bf16 planes, 146 KB at dc + dr = 576) leaves one block an
//     SM;
//   * the block walks its row's tokens in steps of 16 (a step is one page at
//     T = 16, two at T = 8, half a page at T = 32), up to the tile's last
//     causal position; a step's [c | kr] rows are staged by 16-byte
//     cp.async into a two-stage ring (step n + 1 loads while step n
//     computes), rows padded by 16 bytes (conflict-free ldmatrix). Tokens
//     at or past lengths[b] are zero-filled (src-size 0), never read, and
//     table[b, p] is read only for live pages and clamped into [0, P);
//   * bf16 pool, tensor cores (mma.sync.m16n8k16, bf16 in, fp32
//     accumulate): the pool values are exact bf16 operands; each fp32
//     query is staged once as two bf16 terms, hi = bf16(q) and lo =
//     bf16(q - hi) (residual <= 2^-18 |q|), both mma'd into one fp32
//     accumulator. The two warps of a row group each score the 16 keys
//     over one half of the 576 features, exchange the halves through
//     shared memory and add them in one fixed order. P.C splits p into
//     hi + lo as flash_attention.cu does: two mma's into one fp32
//     accumulator;
//   * fp32 pool (the fp32 parity runs): the same tiles, steps, exchange and
//     partitions, with the inner products as scalar fp32 FMAs on the CUDA
//     cores (fp32 operands have no exact bf16 form);
//   * the online softmax follows kernel.py's rules on the mma accumulator
//     layout (a row's 4 lanes reduce with two xor shuffles): running max
//     from -1e30, masked scores selected to -1e30 and their probabilities
//     to 0, finish divides by max(l, 1e-30);
//   * split-KV with fixed partitions of kPagesPerPart = 8 pages (never
//     derived from the card, the shapes or the lengths): each partition of
//     a row starts from (m, l, acc) = (-1e30, 0, 0), and the partitions are
//     folded in ascending order, skipping those with l == 0 (a partition
//     the row sees no key of), by one formula (fold_weights, fold_add):
//     the first live partition is taken as it is; each later one rescales
//     the running (den, num) by exp(M - M') and adds (l, acc) * exp(m -
//     M'). Two routes fold with it, chosen from the shapes alone (L, B,
//     Qmax, H, dc, MP), never from the lengths:
//       - split: one block per (tile, partition) writes its rows' (m, l,
//         acc) to fp32 scratch that the caller allocates, then
//         mla_paged_attention_combine_kernel (one warp a row) folds them;
//         taken when the table has more than one partition and the scratch
//         fits kScratchCapFloats (128 MiB): every decode shape;
//       - in-block: one block per tile walks all its partitions and folds
//         each into the output buffer (its own rows' running num, in
//         place), finishing at the last one; taken for one partition or
//         past the cap (a Qmax 128 chunk needs 2.16 GB of scratch). The
//         running num round-trips through L2 (registers hold one
//         accumulator, shared memory the query tile), its loads batched
//         8 deep.
//     Both run the same partition code and the same fold, so they give the
//     same bits.
// Bitwise pins, by construction: a row's arithmetic depends on no tile, no
// Qmax and no neighbouring row (mma rows are independent; tails of Qmax * H
// are masked, not given another instruction mix); a step fully masked for
// a row leaves its partition state unchanged (corr = exp(0) = 1, every
// probability 0, dead slots zero-filled so a zero probability multiplies a
// finite 0 — NaN or inf in a dead slot never reaches an mma); a partition
// with l == 0 is skipped. So q_len == 1 ragged is the decode launch, layer l
// of a multi-layer launch is the single-layer launch, and the split route
// is the in-block route. No atomic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;                        // (query, head) rows a block
constexpr int kKeys = 16;                        // tokens a step
constexpr int kPagesPerPart = 8;
// fp32 elements of split-KV scratch a launch may use (128 MiB)
constexpr int64_t kScratchCapFloats = int64_t{1} << 25;
constexpr int kMaxWidth = 576;                   // dc + dr (shared memory)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCombineWarps = 8;

// A part kernel's block: 4 row groups of 16 rows times kCG column groups,
// each owning dc / kCG latent columns of the output and 1 / kCG of the
// score depth
constexpr int kCG = 2;
constexpr int kThreads = 4 * kCG * 32;

// Per pool type: elements a 16-byte chunk, q planes (bf16 hi and lo, or
// fp32), the score exchange's row (floats) and the shared memory a block
// takes at rope width DR.
template <typename pool_t>
struct Pool {
  static constexpr bool kMma = std::is_same<pool_t, __nv_bfloat16>::value;
  static constexpr int kE = 16 / static_cast<int>(sizeof(pool_t));
  static constexpr int kQPlanes = kMma ? 2 : 1;
  static constexpr int kSX = kMma ? 24 : 16;
  static size_t smem(int DC, int DR) {
    return sizeof(pool_t) * (kQPlanes * kRows + 2 * kKeys) * (DC + DR + kE) +
           sizeof(float) * (kCG * kRows * kSX + 2 * kCG * kRows + kRows);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronous; zero-filled when !pred (src is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// (x, y) = hi + lo + r, hi and lo bf16 pairs, |r| <= 2^-18 |x|, |y|
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}
// the warps of one row group (`threads` of them)
__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads));
}

// The tokens a row tile sees: up to its last valid query's causal position
// (0 for a tile of padding rows). Both kernels call it.
__device__ __forceinline__ int tile_tokens(int row0, int valid_end,
                                           int length, int q_len, int H,
                                           int T, int MP) {
  if (row0 >= valid_end) return 0;
  const int r_last = min(row0 + kRows, valid_end) - 1;
  const int pos_last = length - q_len + r_last / H;
  return pos_last >= 0 ? min(pos_last + 1, MP * T) : 0;
}

// The ordered fold of a row's partitions, shared by both routes: the
// running max M moves to max(M, m) and the weights of the running sums and
// of the new partition follow; explicit roundings, so every call site
// gives the same bits.
__device__ __forceinline__ float2 fold_weights(float& M, float m) {
  const float Mn = fmaxf(M, m);
  const float2 w = make_float2(expf(M - Mn), expf(m - Mn));
  M = Mn;
  return w;
}
__device__ __forceinline__ float fold_add(float run, float part, float2 w) {
  return __fmaf_rn(part, w.y, __fmul_rn(run, w.x));
}
__device__ __forceinline__ float finish(float num, float den) {
  return __fdiv_rn(num, fmaxf(den, 1e-30f));
}

template <typename pool_t, int DC>
__global__ void __launch_bounds__(kThreads, 1)
mla_paged_attention_part_kernel(const float* __restrict__ q_c,
                                const float* __restrict__ q_r,
                                const pool_t* __restrict__ pool_c,
                                const pool_t* __restrict__ pool_kr,
                                const int32_t* __restrict__ table,
                                const int32_t* __restrict__ lengths,
                                const int32_t* __restrict__ q_lens,
                                float* __restrict__ out,
                                float* __restrict__ part_ml,
                                float* __restrict__ part_acc, int B, int Qm,
                                int H, int DR, int P, int T, int MP,
                                int n_parts, int fold, float scale) {
  constexpr bool kMma = Pool<pool_t>::kMma;
  constexpr int kE = Pool<pool_t>::kE;
  constexpr int kQPlanes = Pool<pool_t>::kQPlanes;
  constexpr int kSX = Pool<pool_t>::kSX;
  constexpr int kCols = DC / kCG;                // latent columns a warp
  constexpr int kNT = kCols / 8;                 // 8-wide output tiles
  static_assert(DC % 32 == 0 && kNT % 2 == 0, "latent width");
  const int W = DC + DR;
  const int kStride = W + kE;                    // padded smem row

  extern __shared__ __align__(16) unsigned char mla_smem[];
  pool_t* q_s = reinterpret_cast<pool_t*>(mla_smem);   // (planes, 64, W)
  pool_t* st_s = q_s + kQPlanes * kRows * kStride;     // (2, 16, W)
  float* sx = reinterpret_cast<float*>(st_s + 2 * kKeys * kStride);
  // each warp's copy of its rows' running max M and denominator (only read
  // at partition ends; registers are the scarce resource)
  float* fold_s = sx + kCG * kRows * kSX;
  int* lim_s = reinterpret_cast<int*>(fold_s + 2 * kCG * kRows);

  const int z = blockIdx.y, layer = z / B, b = z % B;
  const int tile = fold ? blockIdx.x : blockIdx.x / n_parts;
  const int n_rows = Qm * H;
  const int row0 = tile * kRows;
  const int length = lengths[b];
  const int q_len = q_lens[b];
  const int valid_end = min(n_rows, max(q_len, 0) * H);
  const int n_tok = tile_tokens(row0, valid_end, length, q_len, H, T, MP);
  const int part_tok = kPagesPerPart * T;
  const int n_live = (n_tok + part_tok - 1) / part_tok;
  const int spp = part_tok / kKeys;              // steps a partition
  const int n_steps = (n_tok + kKeys - 1) / kKeys;
  int p0 = 0, p1 = n_live;
  if (!fold) {
    p0 = blockIdx.x % n_parts;
    if (p0 >= n_live) return;                    // past the tile's tokens
    p1 = p0 + 1;
  }
  const int64_t rows_ls = static_cast<int64_t>(B) * n_rows;  // per layer
  const int64_t pool_ls = static_cast<int64_t>(P) * T;
  q_c += layer * rows_ls * DC;
  q_r += layer * rows_ls * DR;
  out += layer * rows_ls * DC;
  pool_c += layer * pool_ls * DC;
  pool_kr += layer * pool_ls * DR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp & 3, cg = warp >> 2;       // row group, column group
  const int g = lane >> 2, c4 = lane & 3;
  const int live_end = min(length, MP * T);

  // step s's [c | kr] rows into ring stage s & 1: 16 threads a token,
  // each looking its page up once and copying every 16th chunk
  auto stage = [&](int s) {
    pool_t* dst = st_s + (s & 1) * kKeys * kStride;
    const int cc = DC / kE, n_ch = cc + DR / kE;  // 16 B chunks a token
    const int t = threadIdx.x / (kThreads / kKeys);
    const int tok = s * kKeys + t;
    const bool live = tok < live_end;
    int64_t tg = 0;
    if (live) {
      const int phys = min(
          max(table[static_cast<int64_t>(b) * MP + tok / T], 0), P - 1);
      tg = static_cast<int64_t>(phys) * T + tok % T;
    }
    for (int ch = threadIdx.x % (kThreads / kKeys); ch < n_ch;
         ch += kThreads / kKeys) {
      const pool_t* src = !live  ? pool_c
                          : ch < cc ? pool_c + tg * DC + ch * kE
                                    : pool_kr + tg * DR + (ch - cc) * kE;
      cp_async16(dst + t * kStride + ch * kE, src, live);
    }
    cp_async_commit();
  };

  const int s_end = min(p1 * spp, n_steps);
  if (n_live > 0) {
    // the tile's queries, once: fp32 by cp.async (fp32 pool), or bf16 hi
    // and lo planes from loads batched kBatch deep (bf16 pool)
    const int n_ch = W / 8;                      // 8-feature chunks a row
    const int n_q = kRows * n_ch;
    auto q_src = [&](int idx, int& r, int& d) {
      r = idx / n_ch;
      d = idx % n_ch * 8;
      const int64_t qh = static_cast<int64_t>(b) * n_rows + row0 + r;
      return d < DC ? q_c + qh * DC + d : q_r + qh * DR + d - DC;
    };
    if constexpr (kMma) {
      constexpr int kBatch = 6;
      for (int base = threadIdx.x; base < n_q; base += kThreads * kBatch) {
        float4 x[kBatch][2];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          int r, d;
          const int idx = base + k * kThreads;
          x[k][0] = x[k][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < n_q) {
            const float* src = q_src(idx, r, d);
            if (row0 + r < valid_end) {
              x[k][0] = *reinterpret_cast<const float4*>(src);
              x[k][1] = *reinterpret_cast<const float4*>(src + 4);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          int r, d;
          const int idx = base + k * kThreads;
          if (idx >= n_q) break;
          q_src(idx, r, d);
          uint4 hi, lo;
          split_bf16(x[k][0].x, x[k][0].y, hi.x, lo.x);
          split_bf16(x[k][0].z, x[k][0].w, hi.y, lo.y);
          split_bf16(x[k][1].x, x[k][1].y, hi.z, lo.z);
          split_bf16(x[k][1].z, x[k][1].w, hi.w, lo.w);
          *reinterpret_cast<uint4*>(q_s + r * kStride + d) = hi;
          *reinterpret_cast<uint4*>(q_s + (kRows + r) * kStride + d) = lo;
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < n_q; idx += kThreads) {
        int r, d;
        const float* src = q_src(idx, r, d);
        const bool ok = row0 + r < valid_end;
        cp_async16(q_s + r * kStride + d, ok ? src : q_c, ok);
        cp_async16(q_s + r * kStride + d + 4, ok ? src + 4 : q_c, ok);
      }
    }
    stage(p0 * spp);                 // commits the queries' copies too
  }

  // this lane's rows: tile rows ra and ra + 8 (i = 0, 1)
  const int ra = rg * 16 + g;
  // bit i of `have`: row i's running (M, den, num) holds a partition;
  // lim_s[r]: the keys below it are the ones tile row r sees (0 for
  // padding), in shared memory (registers are the scarce resource)
  int have = 0;
  float m[2], l[2];
  if (threadIdx.x < kRows) {
    const int row = row0 + threadIdx.x;
    lim_s[threadIdx.x] =
        row < valid_end ? max(length - q_len + row / H + 1, 0) : 0;
  }
  float acc[kNT][4];
  // ldmatrix lane offsets: A (16 rows x 16), K rows (16 keys x 16), and
  // C rows transposed (16 keys x 16 latent features of this half)
  const int a_off =
      (rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
      (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kStride +
                    ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                    cg * kCols + (lane >> 4) * 8;
  const int n_ks = W / 16;                       // 16-feature score steps
  const int ks0 = n_ks * cg / kCG, ks1 = n_ks * (cg + 1) / kCG;

  for (int p = p0; p < p1; ++p) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    const int s_stop = min((p + 1) * spp, n_steps);
    for (int s = p * spp; s < s_stop; ++s) {
      cp_async_wait_all();
      __syncthreads();               // step s landed; step s - 1 done
      if (s + 1 < s_end) stage(s + 1);
      const pool_t* st = st_s + (s & 1) * kKeys * kStride;

      // this warp's part of the scores: s[j] = key tile j (8 keys), in
      // the mma accumulator layout (rows g, g + 8; keys 2 c4, 2 c4 + 1)
      float sc[2][4];
      if constexpr (kMma) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 2
        for (int ks = ks0; ks < ks1; ++ks) {
          uint32_t ah[4], al[4], kb[4];
          ldmatrix_x4(ah, q_s + a_off + ks * 16);
          ldmatrix_x4(al, q_s + kRows * kStride + a_off + ks * 16);
          ldmatrix_x4(kb, st + b_off + ks * 16);
          mma_bf16(sc[0], ah, kb[0], kb[1]);
          mma_bf16(sc[1], ah, kb[2], kb[3]);
          mma_bf16(sc[0], al, kb[0], kb[1]);
          mma_bf16(sc[1], al, kb[2], kb[3]);
        }
      } else {
        float dot[2][2][2];                      // row i, key tile j, key e
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) dot[i][j][0] = dot[i][j][1] = 0.f;
        const float* qa = q_s + ra * kStride;
        const float* qb = qa + 8 * kStride;
#pragma unroll 2
        for (int d = ks0 * 16; d < ks1 * 16; d += 4) {
          const float4 xa = *reinterpret_cast<const float4*>(qa + d);
          const float4 xb = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 k = *reinterpret_cast<const float4*>(
                  st + (j * 8 + 2 * c4 + e) * kStride + d);
              float x = dot[0][j][e], y = dot[1][j][e];
              x = fmaf(xa.x, k.x, x);
              y = fmaf(xb.x, k.x, y);
              x = fmaf(xa.y, k.y, x);
              y = fmaf(xb.y, k.y, y);
              x = fmaf(xa.z, k.z, x);
              y = fmaf(xb.z, k.z, y);
              x = fmaf(xa.w, k.w, x);
              y = fmaf(xb.w, k.w, y);
              dot[0][j][e] = x;
              dot[1][j][e] = y;
            }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sc[j][0] = dot[0][j][0];
          sc[j][1] = dot[0][j][1];
          sc[j][2] = dot[1][j][0];
          sc[j][3] = dot[1][j][1];
        }
      }
      // exchange the parts: s = part 0 + part 1 (+ ...), in that order
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(
              sx + (cg * kRows + ra + 8 * i) * kSX + j * 8 + 2 * c4) =
              make_float2(sc[j][2 * i], sc[j][2 * i + 1]);
      group_barrier(1 + rg, 32 * kCG);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at = (ra + 8 * i) * kSX + j * 8 + 2 * c4;
          float2 h = *reinterpret_cast<const float2*>(sx + at);
#pragma unroll
          for (int k = 1; k < kCG; ++k) {
            const float2 x =
                *reinterpret_cast<const float2*>(sx + k * kRows * kSX + at);
            h.x += x.x;
            h.y += x.y;
          }
          sc[j][2 * i] = h.x;
          sc[j][2 * i + 1] = h.y;
        }

      // online softmax, kernel.py's rules
      const int tok0 = s * kKeys;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = tok0 + j * 8 + 2 * c4 + e;
            const float x = key < lim_s[ra + 8 * i]
                                ? sc[j][2 * i + e] * scale
                                : kNegInf;
            sc[j][2 * i + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = sc[j][2 * i + e];
            const float pr = x > kNegInf * 0.5f ? expf(x - m_new) : 0.f;
            sc[j][2 * i + e] = pr;
            sum += pr;
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }

      // P.C over this warp's latent half
      if constexpr (kMma) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
        split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
        split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
        split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
        for (int dt2 = 0; dt2 < kNT / 2; ++dt2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, st + v_off + dt2 * 16);
          mma_bf16(acc[2 * dt2], ph, vb[0], vb[1]);
          mma_bf16(acc[2 * dt2 + 1], ph, vb[2], vb[3]);
          mma_bf16(acc[2 * dt2], pl, vb[0], vb[1]);
          mma_bf16(acc[2 * dt2 + 1], pl, vb[2], vb[3]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < kKeys; ++t) {
          const int src = (lane & ~3) | ((t & 7) >> 1);
          const float pa = __shfl_sync(kFull, sc[t >> 3][t & 1], src);
          const float pb = __shfl_sync(kFull, sc[t >> 3][2 + (t & 1)], src);
          const float* v = st + t * kStride + cg * kCols + 2 * c4;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const float2 x = *reinterpret_cast<const float2*>(v + n * 8);
            acc[n][0] = fmaf(pa, x.x, acc[n][0]);
            acc[n][1] = fmaf(pa, x.y, acc[n][1]);
            acc[n][2] = fmaf(pb, x.x, acc[n][2]);
            acc[n][3] = fmaf(pb, x.y, acc[n][3]);
          }
        }
      }
    }

    // this partition's state of each valid row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + ra + 8 * i;
      if (row >= valid_end) continue;
      if (!fold) {                   // split: to the scratch, (z, row, part)
        const int64_t at =
            (static_cast<int64_t>(z) * n_rows + row) * n_parts + p;
        if (c4 == 0 && cg == 0) {
          part_ml[2 * at] = m[i];
          part_ml[2 * at + 1] = l[i];
        }
        float* a = part_acc + at * DC + cg * kCols + 2 * c4;
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          *reinterpret_cast<float2*>(a + n * 8) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        continue;
      }
      // in-block: fold into the row's running num, kept in `out`
      float* o = out + (static_cast<int64_t>(b) * n_rows + row) * DC +
                 cg * kCols + 2 * c4;
      const bool last = p + 1 == p1;
      const bool live = l[i] != 0.f;
      const bool first = !(have >> i & 1);   // no running num yet
      if (!live && (first || !last)) continue;
      float* Mp = fold_s + cg * kRows + ra + 8 * i;
      float* denp = Mp + kCG * kRows;
      float2 w = make_float2(1.f, 1.f);
      float den = first ? 0.f : *denp;
      if (live && first) {
        *Mp = m[i];
        den = l[i];
        have |= 1 << i;
      } else if (live) {
        float M = *Mp;
        w = fold_weights(M, m[i]);
        *Mp = M;
        den = fold_add(den, l[i], w);
      }
      *denp = den;
      // kB tiles at a time: the running num's loads first, then the fold
      // and the stores (the result at the last partition)
      constexpr int kB = kNT < 8 ? kNT : 8;
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += kB) {
        float2 r[kB];
        if (!first) {
#pragma unroll
          for (int k = 0; k < kB; ++k)
            r[k] = *reinterpret_cast<const float2*>(o + (n0 + k) * 8);
        }
#pragma unroll
        for (int k = 0; k < kB; ++k) {
          float x, y;
          if (live) {
            x = acc[n0 + k][2 * i];
            y = acc[n0 + k][2 * i + 1];
            if (!first) {
              x = fold_add(r[k].x, x, w);
              y = fold_add(r[k].y, y, w);
            }
          } else {
            x = r[k].x;
            y = r[k].y;
          }
          if (last) {
            x = finish(x, den);
            y = finish(y, den);
          }
          *reinterpret_cast<float2*>(o + (n0 + k) * 8) = make_float2(x, y);
        }
      }
    }
  }

  // in-block: rows that saw no key, padding slots and the tail are 0
  if (fold) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + ra + 8 * i;
      if (row >= n_rows || (row < valid_end && (have >> i & 1))) continue;
      float* o = out + (static_cast<int64_t>(b) * n_rows + row) * DC +
                 cg * kCols + 2 * c4;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        *reinterpret_cast<float2*>(o + n * 8) = make_float2(0.f, 0.f);
    }
  }
}

// The split route's fold: one warp = one (layer, b, row); lane owns latent
// features lane, lane + 32, ...
template <int DC>
__global__ void __launch_bounds__(kCombineWarps * 32)
mla_paged_attention_combine_kernel(const float* __restrict__ part_ml,
                                   const float* __restrict__ part_acc,
                                   const int32_t* __restrict__ lengths,
                                   const int32_t* __restrict__ q_lens,
                                   float* __restrict__ out, int64_t n_total,
                                   int B, int Qm, int H, int T, int MP,
                                   int n_parts) {
  constexpr int kF = DC / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t gr = static_cast<int64_t>(blockIdx.x) * kCombineWarps + warp;
  if (gr >= n_total) return;
  const int n_rows = Qm * H;
  const int z = static_cast<int>(gr / n_rows);
  const int row = static_cast<int>(gr % n_rows), b = z % B;
  const int length = lengths[b];
  const int q_len = q_lens[b];
  const int valid_end = min(n_rows, max(q_len, 0) * H);
  const int row0 = row / kRows * kRows;
  const int n_tok = tile_tokens(row0, valid_end, length, q_len, H, T, MP);
  const int part_tok = kPagesPerPart * T;
  const int n_live = row < valid_end ? (n_tok + part_tok - 1) / part_tok : 0;
  float num[kF];
  float M = kNegInf, den = 0.f;
  bool have = false;
  // lane q reads partition base + q's (m, l); the live ones (l != 0) are
  // then folded in ascending order, their accumulators loaded ahead of
  // the running sums
  for (int base = 0; base < n_live; base += 32) {
    const int64_t at0 = gr * n_parts + base;
    float mq = 0.f, lq = 0.f;
    if (base + lane < n_live) {
      mq = part_ml[2 * (at0 + lane)];
      lq = part_ml[2 * (at0 + lane) + 1];
    }
    unsigned live = __ballot_sync(kFull, lq != 0.f);
    while (live) {
      const int q = __ffs(live) - 1;
      live &= live - 1;
      const float mp = __shfl_sync(kFull, mq, q);
      const float lp = __shfl_sync(kFull, lq, q);
      const float* a = part_acc + (at0 + q) * DC;
      float x[kF];
#pragma unroll
      for (int j = 0; j < kF; ++j) x[j] = a[j * 32 + lane];
      if (!have) {
        M = mp;
        den = lp;
#pragma unroll
        for (int j = 0; j < kF; ++j) num[j] = x[j];
        have = true;
      } else {
        const float2 w = fold_weights(M, mp);
        den = fold_add(den, lp, w);
#pragma unroll
        for (int j = 0; j < kF; ++j) num[j] = fold_add(num[j], x[j], w);
      }
    }
  }
  float* o = out + gr * DC;
#pragma unroll
  for (int j = 0; j < kF; ++j)
    o[j * 32 + lane] = have ? finish(num[j], den) : 0.f;
}

// How a launch runs: the split route when the table has more than one
// partition and its scratch fits the cap, else the in-block fold.
struct Plan {
  int n_rows, n_tiles, n_parts;
  int64_t floats;                                // split-route scratch
  bool split;
};

Plan plan_of(int L, int B, int Qm, int H, int DC, int MP) {
  Plan p;
  p.n_rows = Qm * H;
  p.n_tiles = (p.n_rows + kRows - 1) / kRows;
  p.n_parts = (MP + kPagesPerPart - 1) / kPagesPerPart;
  p.floats = static_cast<int64_t>(L) * B * p.n_rows * p.n_parts * (DC + 2);
  p.split = p.n_parts > 1 && p.floats <= kScratchCapFloats;
  return p;
}

template <typename pool_t, int DC>
cudaError_t launch(const void* q_c, const void* q_r, const void* pool_c,
                   const void* pool_kr, const void* table,
                   const void* lengths, const void* q_lens, void* out,
                   void* scratch, int L, int B, int Qm, int H, int DR, int P,
                   int T, int MP, float scale, cudaStream_t stream) {
  auto kernel = mla_paged_attention_part_kernel<pool_t, DC>;
  const size_t smem = Pool<pool_t>::smem(DC, DR);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const Plan pl = plan_of(L, B, Qm, H, DC, MP);
  float* part_ml = static_cast<float*>(scratch);
  const int64_t entries = pl.floats / (DC + 2);
  float* part_acc = part_ml + 2 * entries;
  if (pl.split && scratch == nullptr) return cudaErrorInvalidValue;
  const int64_t gx = static_cast<int64_t>(pl.n_tiles) *
                     (pl.split ? pl.n_parts : 1);
  if (gx > 0x7fffffff) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(gx), L * B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q_c), static_cast<const float*>(q_r),
      static_cast<const pool_t*>(pool_c), static_cast<const pool_t*>(pool_kr),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(q_lens), static_cast<float*>(out), part_ml,
      part_acc, B, Qm, H, DR, P, T, MP, pl.n_parts, pl.split ? 0 : 1, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !pl.split) return err;
  const int64_t n_total = static_cast<int64_t>(L) * B * pl.n_rows;
  mla_paged_attention_combine_kernel<DC>
      <<<static_cast<unsigned>((n_total + kCombineWarps - 1) / kCombineWarps),
         kCombineWarps * 32, 0, stream>>>(part_ml, part_acc, static_cast<const int32_t*>(lengths),
                   static_cast<const int32_t*>(q_lens),
                   static_cast<float*>(out), n_total, B, Qm, H, T, MP,
                   pl.n_parts);
  return cudaGetLastError();
}

template <typename pool_t>
cudaError_t dispatch(int DC, const void* q_c, const void* q_r,
                     const void* pool_c, const void* pool_kr,
                     const void* table, const void* lengths,
                     const void* q_lens, void* out, void* scratch, int L,
                     int B, int Qm, int H, int DR, int P, int T, int MP,
                     float scale, cudaStream_t stream) {
#define MLA_CASE(CC)                                                        \
  if (DC == CC)                                                             \
    return launch<pool_t, CC>(q_c, q_r, pool_c, pool_kr, table, lengths,    \
                              q_lens, out, scratch, L, B, Qm, H, DR, P, T,  \
                              MP, scale, stream);
  MLA_CASE(32) MLA_CASE(64) MLA_CASE(128) MLA_CASE(256) MLA_CASE(512)
#undef MLA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// fp32 elements of split-KV scratch an MLA launch of these shapes takes:
// its (m, l) and dc-wide accumulator for each (layer, b, row, partition),
// or 0 when the launch folds its partitions in the block (one partition,
// or past the 128 MiB cap). Shapes only: no lengths.
extern "C" int64_t mla_paged_attention_scratch_floats(int L, int B, int Qm,
                                                      int H, int DC,
                                                      int MP) {
  if (L <= 0 || B <= 0 || Qm <= 0 || H <= 0 || MP <= 0) return 0;
  const Plan pl = plan_of(L, B, Qm, H, DC, MP);
  return pl.split ? pl.floats : 0;
}

// The pages of one split-KV partition (a compile-time constant).
extern "C" int mla_paged_attention_pages_per_part() { return kPagesPerPart; }

// q_c (L, B, Qm, H, DC) and q_r (L, B, Qm, H, DR) fp32; pool_c
// (L, P, T, DC) and pool_kr (L, P, T, DR) of pool_dtype (0 = float32,
// 1 = bfloat16); table (B, MP), lengths and q_lens (B,) int32, shared by
// every layer; scratch of mla_paged_attention_scratch_floats fp32 (may be
// null when that is 0); out (L, B, Qm, H, DC) fp32. Returns a cudaError_t
// (0 = launched).
extern "C" int mla_paged_attention_layers_ragged_launch(
    const void* q_c, const void* q_r, const void* pool_c, const void* pool_kr,
    const void* table, const void* lengths, const void* q_lens, void* out,
    void* scratch, int L, int B, int Qm, int H, int DC, int DR, int P, int T,
    int MP, float scale, int pool_dtype, void* stream) {
  if (L <= 0 || B <= 0 || Qm <= 0) return cudaSuccess;
  if (H <= 0 || P <= 0 || MP <= 0 || T <= 0 || T % 2 != 0 || DR <= 0 ||
      DR % 16 != 0 || DC + DR > kMaxWidth ||
      static_cast<int64_t>(L) * B > 65535)          // gridDim.y
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 0)
    return dispatch<float>(DC, q_c, q_r, pool_c, pool_kr, table, lengths,
                           q_lens, out, scratch, L, B, Qm, H, DR, P, T, MP,
                           scale, s);
  if (pool_dtype == 1)
    return dispatch<bf16>(DC, q_c, q_r, pool_c, pool_kr, table, lengths,
                          q_lens, out, scratch, L, B, Qm, H, DR, P, T, MP,
                          scale, s);
  return cudaErrorInvalidValue;
}
