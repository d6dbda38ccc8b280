// Flash attention, forward, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _fa_kernel)
// of src/repro/kernels/flash_attention/kernel.py: causal or non-causal GQA
// attention of q (B, Sq, H, D) over k (B, Skv, K, D) and v (B, Skv, K, DV)
// into out (B, Sq, H, DV), query head h reading KV head h / (H / K). The
// Pallas kernel takes one width for all four; here the qk width D and the v
// width DV are two template parameters, so MLA prefill (DeepSeek-V2: D =
// qk_nope + qk_rope = 192, DV = v_head = 128) runs without padding q and k
// to 256 (a third more qk bytes) or v to 192 (wasted output registers).
// Built for (D, DV) = (32, 32), (64, 64), (128, 128), (256, 256) and
// (192, 128). Causal queries are the LAST Sq positions of
// the Skv keys: query i sits at position i + Skv - Sq and sees the keys at
// or before it. q, k and v are fp32 or bf16 of one type; the softmax and
// every sum are fp32 (bf16 products are exact, fp32 ones 3xTF32: ~2^-22
// relative), the output has q's type. A
// query row that sees no key (causal with Sq > Skv) is exactly 0: the
// Pallas kernel skips every block of such rows (its `live` test) and
// leaves them 0 at the block sizes the JAX package's tests use; the jnp
// oracle returns the mean of V there (ROADMAP.md, section 3).
//
// Bound: operations. A causal S = 4096, H = 16, D = 128 prefill layer is
// 4 * D * H * S (S + 1) / 2 = 68.7 GFLOP over 16 MB of q, k, v and output,
// thousands of flop per byte, far above both ridges: 0.069 ms at the bf16
// rate (989 TFLOP/s); in fp32, three TF32 products each, 3 * 68.7 GFLOP at
// 495 TFLOP/s = 0.417 ms (1.026 ms at the CUDA cores' 67 TFLOP/s).
//
// Two kernels, one per element type, with one contract (below):
//
// bf16 — flash_attention_mma_kernel, FlashAttention-2 on the warp-level
// tensor cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate):
//   * one block = one (b, KV head) and a tile of 64 query rows, row r =
//     query i * G + group g (the G heads of a KV head share each staged K/V
//     tile); 4 warps of 16 rows; the heaviest causal tiles are scheduled
//     first;
//   * K/V tiles of 64 keys are staged as bf16 with 16-byte cp.async into a
//     two-stage ring (tile n + 1 loads while tile n computes; one
//     __syncthreads a tile), rows padded by 16 bytes so ldmatrix reads are
//     conflict-free; keys past Skv are zero-filled (cp.async src-size 0);
//   * S = Q.K^T on the tensor cores: q and k are bf16, so each product is
//     exact and only the order of the fp32 sum differs from the plain
//     version; Q fragments stay in registers for D <= 128 and are re-read
//     from shared memory at D = 192 and 256 (registers: 24 or 32 more
//     fragment words would join the DV / 2 fp32 of output);
//   * the online softmax runs in fp32 registers on the mma accumulator
//     layout (a row's 4 lanes reduce with two xor shuffles) with kernel.py's
//     rules: running max from -1e30, masked probabilities forced to 0,
//     l summed from the fp32 p, finish divides by max(l, 1e-30); scores
//     are kept in log2 units (scale * log2 e folded into one multiply) so
//     each probability is one ex2.approx (relative error ~2^-22; a
//     probability below 2^-126 flushes to 0); only tiles that reach past a
//     row's last key apply the mask;
//   * P.V keeps p's fp32 precision: p = hi + lo with hi = bf16(p), lo =
//     bf16(p - hi) (residual <= 2^-18 p), and two mma's, hi.V and lo.V, go
//     into one fp32 accumulator: 1.5x plain FA2's products, and a bf16
//     output stays within half an ulp of the plain fp32 version.
// Shared memory: Q and two stages of K in rows of D + 8 bf16, two stages of
// V in rows of DV + 8 ((64 + 2 * 64) (D + 8) + 2 * 64 (DV + 8) bf16): 87 KB
// at D = DV = 128 (two blocks an SM), 109 KB at (192, 128) (two), 169 KB at
// D = DV = 256 (one). Registers bound it too: 188 at D = 128; two 16-row
// tiles a warp (FA2's fragment reuse) need more than 255 and spill.
//
// fp32 — flash_attention_tf32x3_kernel, the same structure on the tensor
// cores with fp32 operands as 3xTF32 (mma.sync.m16n8k8, tf32 in, fp32
// accumulate):
//   * one block = one (b, KV head) and a tile of 64 query rows, 4 warps of
//     16, heaviest causal tiles first; K/V tiles staged as fp32 with
//     16-byte cp.async into a two-stage ring (tile n + 1 loads while tile n
//     computes), keys past Skv zero-filled; a warp whose 16 rows are all
//     past the queries loads and waits with the block but computes nothing;
//   * each fp32 operand x is split into hi = rna.tf32(x) and lo =
//     rna.tf32(x - hi) (x - hi is exact; the residual is <= 2^-22 |x|;
//     rna: cvt.rna.tf32.f32's rounding, done by two integer ops), and each
//     product is lo.hi + hi.lo, then hi.hi, into one fp32 accumulator
//     (small terms first, as CUTLASS's 3xTF32 orders them); the dropped
//     lo.lo term is ~2^-22 relative, fp32's own level. Both S = Q.K^T and
//     O += P.V: p and V are split as q and k are;
//   * the tensor cores add with truncation, not rounding, so a long run of
//     mma's into one accumulator drifts toward zero (up to an ulp of the
//     sum a step): a tile's P.V goes into a zeroed accumulator and is
//     folded into O with one fp32 FMA, o * corr + pv. Accumulated in O
//     across the tiles instead, every output stayed within 8.4e-6
//     of the plain version, but the drift is one-signed and parity-encdec's
//     cache planes left the fp32 tolerance. S sums its D products in the
//     accumulator (48 steps at D = 128): a fold per 16-wide chunk lowers
//     the error up to 3.4x but spills at D >= 128, up to 23% slower;
//   * fragments: lane (g, t) = (lane / 4, lane % 4) reads d = 16c + 4t ..
//     16c + 4t + 3 of a row of Q or K for a 16-wide chunk c with one 16-byte
//     shared load; the first two are k-step 2c's k = t and t + 4, the last
//     two k-step 2c + 1's. Q and K share the order, so each product still
//     pairs q and k at one d. In P.V the k = t of an 8-key step is key 2t
//     and k = t + 4 key 2t + 1: the S accumulator's own layout, so p goes
//     from the softmax into the A fragment with no shuffle, and V's B
//     fragment reads rows 2t and 2t + 1 with scalar loads;
//   * Q and K rows padded to D + 16 floats (the two rows a phase of a
//     16-byte load reads fall in other banks), V rows to DV + 4 (the four
//     rows 2t of a scalar read fall in other banks);
//   * Q is split once, at the first tile: for D <= 64 hi and lo stay in
//     registers; for D = 128 and 192 hi stays in registers and each lane
//     writes lo over the fp32 values it read (no other lane reads them),
//     so later tiles load lo ready to use; at D = 256 (hi alone would be
//     128 more registers beside the 128 of output) Q is re-read and split
//     every tile. K, V and p are split as they are loaded;
//   * the online softmax of the bf16 kernel (log2 units, ex2.approx:
//     relative error ~2^-22, 100x inside the fp32 tolerance's rtol of 4e-5;
//     held at every phase-2 shape and card test).
// Shared memory: Q (64 rows) and two stages of kKeys K and V rows,
// 64 (D + 16) + 2 kKeys ((D + 16) + (DV + 4)) floats. Blocks an SM: the
// fewer of what shared memory allows (228 KB an SM, 1 KB reserved a block)
// and what registers allow (ptxas -v of the nvcc 12.9 build, chip_smoke.py
// phase 1; 64 K registers an SM):
//     (D, DV)      kKeys   bytes      registers   blocks an SM
//     (32, 32)       32     33,792       127          4
//     (64, 64)       32     58,368       166          3
//     (128, 128)     32    107,520       254          2
//     (192, 128)     16     96,768       254          2   (32 keys: one)
//     (256, 256)     32    205,824       255          1
// no spills. At (192, 128), 32-key tiles (one block an SM) ran 44-46%
// slower; hi and lo of Q in registers at D = 128 15-16% slower; cvt.rna
// in place of the integer ops 12-29% slower: edited copies of this
// source timed against it with scripts/flash_ab.py (PERF.md, section 6).
//
// Both stop each block's key walk at its last row's causal diagonal (the
// Pallas kernel's `live` block skip). A key tile that is fully masked for a
// row leaves the row's state bitwise unchanged (every probability 0,
// correction exp(0) == 1, the accumulator plus zero products), so a row's
// result does not depend on its tile, on Sq's tiling or on the block sizes
// the caller passes. No split of the keys across blocks, no atomic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------ bf16: tensor cores
using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = kMmaWarps * 16;         // query rows per block
constexpr int kMmaKeys = 64;                     // keys per staged tile

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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int DV>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int Sq, int Skv, int H, int K, int causal,
                           float scale) {
  static_assert(D % 32 == 0 && DV % 16 == 0 && DV <= D, "head dims");
  constexpr int kStride = D + 8;                 // padded smem row: q, k
  constexpr int kStrideV = DV + 8;               // ... and v (bf16)
  constexpr int kChunks = D / 8;                 // 16-byte chunks a row
  constexpr int kChunksV = DV / 8;
  constexpr int kNT = kMmaKeys / 8;              // 8-key tiles of S
  constexpr int kDT = DV / 8;                    // 8-feature tiles of O
  constexpr bool kQRegs = D <= 128;
  constexpr int kTileK = kMmaKeys * kStride;
  constexpr int kStage = kTileK + kMmaKeys * kStrideV;

  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(fa_smem);  // (kMmaRows, kStride)
  bf16* kv_s = q_s + kMmaRows * kStride;         // 2 stages of K, V tiles

  const int G = H / K;
  const int n_rows = Sq * G;
  const int q_offset = Skv - Sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;  // heavy first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  // scores in log2 units: exp(x - m) == exp2(x log2(e) - m log2(e))
  const float scale_log2 = scale * 1.4426950408889634f;

  int n_keys = Skv;
  if (causal) {
    const int r_last = min(row0 + kMmaRows, n_rows) - 1;
    n_keys = min(Skv, max(r_last / G + q_offset + 1, 0));
  }
  const int n_tiles = (n_keys + kMmaKeys - 1) / kMmaKeys;

  for (int idx = threadIdx.x; idx < kMmaRows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bf16* src = q;
    if (row < n_rows) {
      const int qi = row / G, h = kvh * G + row % G;
      src = q + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D + c * 8;
    }
    cp_async16(q_s + r * kStride + c * 8, src, row < n_rows);
  }
  auto load_tile = [&](int t) {
    bf16* ks = kv_s + (t & 1) * kStage;
    bf16* vs = ks + kTileK;
    const int k0 = t * kMmaKeys;
    for (int idx = threadIdx.x; idx < kMmaKeys * kChunks;
         idx += blockDim.x) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool live = k0 + r < Skv;
      const int64_t row =
          live ? (static_cast<int64_t>(b) * Skv + k0 + r) * K + kvh : 0;
      cp_async16(ks + r * kStride + c * 8, k + row * D + c * 8, live);
      if (DV == D || c < kChunksV)                 // v rows are DV <= D wide
        cp_async16(vs + r * kStrideV + c * 8, v + row * DV + c * 8, live);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  // this lane's two rows: gid and gid + 8 of the warp's 16; lim[i] = the
  // keys below it are the ones the row sees (0 past the queries or for a
  // row that sees none)
  int lim[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + gid + 8 * i;
    lim[i] = row >= n_rows ? 0
             : causal      ? min(Skv, max(row / G + q_offset + 1, 0))
                           : Skv;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  // ldmatrix lane addresses: A (16 rows x 16) and B^T (8 keys x 32) tiles
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = lane & 7, k_col = (lane >> 3) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();             // tile t (and, at t = 0, Q) landed
    __syncthreads();                 // ... for every thread; tile t - 1 done
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc)
          ldmatrix_x4(qf[kc], q_s + a_row * kStride + kc * 16 + a_col);
      }
    }
    const bf16* ks = kv_s + (t & 1) * kStage;
    const bf16* vs = ks + kTileK;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc2 = 0; kc2 < D / 32; ++kc2) {
      uint32_t qa[4], qb[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[2 * kc2][e];
          qb[e] = qf[2 * kc2 + 1][e];
        }
      } else {
        ldmatrix_x4(qa, q_s + a_row * kStride + kc2 * 32 + a_col);
        ldmatrix_x4(qb, q_s + a_row * kStride + kc2 * 32 + 16 + a_col);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (nt * 8 + k_row) * kStride + kc2 * 32 + k_col);
        mma_bf16(s[nt], qa, kb[0], kb[1]);
        mma_bf16(s[nt], qb, kb[2], kb[3]);
      }
    }

    const int k0 = t * kMmaKeys;
    // only a tile that reaches past a row's last key needs the mask
    const bool masked = k0 + kMmaKeys > min(lim[0], lim[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + nt * 8 + tig * 2 + j;
          const float x = !masked || key < lim[i]
                              ? s[nt][2 * i + j] * scale_log2
                              : kNegInf;
          s[nt][2 * i + j] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = fast_exp2(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = s[nt][2 * i + j];
          const float p = x > kNegInf * 0.5f ? fast_exp2(x - m_new) : 0.f;
          s[nt][2 * i + j] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][2 * i] *= corr;
        o[dt][2 * i + 1] *= corr;
      }
    }

#pragma unroll
    for (int kc = 0; kc < kMmaKeys / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dt2 = 0; dt2 < DV / 16; ++dt2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kStrideV +
                                  dt2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dt2], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dt2 + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dt2], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dt2 + 1], pl, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + gid + 8 * i;
    if (row >= n_rows) continue;
    const int qi = row / G, h = kvh * G + row % G;
    bf16* o_row = out + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * DV;
    const float denom = fmaxf(l[i], 1e-30f);     // a row with no key: 0 / .
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o_row + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(o[dt][2 * i] / denom,
                                o[dt][2 * i + 1] / denom);
  }
}

// ------------------------------------------------ fp32: 3xTF32 tensor cores
constexpr int kTfWarps = 4;
constexpr int kTfRows = kTfWarps * 16;           // query rows per block

// keys per staged K/V tile: 32, and 16 at D = 192, where 32 would leave
// one block an SM (the table above)
template <int D>
constexpr int kTf32Keys = D == 192 ? 16 : 32;

template <int D, int DV>
constexpr size_t tf32_smem_bytes() {
  return sizeof(float) * (kTfRows * (D + 16) +
                          2 * kTf32Keys<D> * ((D + 16) + (DV + 4)));
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) in two
// integer ops: half a TF32 ulp added to the magnitude bits, the low 13 bits
// cleared. The same bits as the cvt for finite x, and faster on the card
// (PERF.md, section 6).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo + r: hi = tf32(x), lo = tf32(x - hi), |r| <= 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// d (16x8 fp32) += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a.b in 3xTF32: lo.hi and hi.lo first, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

template <int D, int DV>
__global__ void __launch_bounds__(kTfWarps * 32)
flash_attention_tf32x3_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ out, int Sq, int Skv, int H,
                              int K, int causal, float scale) {
  static_assert(D % 32 == 0 && DV % 32 == 0 && DV <= D, "head dims");
  constexpr int kKeys = kTf32Keys<D>;
  constexpr int kQS = D + 16;                    // padded smem row: q, k
  constexpr int kVS = DV + 4;                    // ... and v
  constexpr int kNT = kKeys / 8;                 // 8-key tiles of S
  constexpr int kDT = DV / 8;                    // 8-feature tiles of O
  constexpr int kDC = D / 16;                    // 16-wide chunks of d
  // Q's split fragments: 2 = hi and lo kept in registers, 1 = hi in
  // registers and lo written over Q's fp32 row in shared memory, 0 = re-read
  // and split every tile (registers: the output alone is DV / 2 a lane)
  constexpr int kQKeep = D <= 64 ? 2 : D <= 192 ? 1 : 0;
  constexpr int kTileK = kKeys * kQS;
  constexpr int kStage = kTileK + kKeys * kVS;

  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* q_s = reinterpret_cast<float*>(fa_smem);  // (kTfRows, kQS)
  float* kv_s = q_s + kTfRows * kQS;             // 2 stages of K, V tiles

  const int G = H / K;
  const int n_rows = Sq * G;
  const int q_offset = Skv - Sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTfRows;  // heavy first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool warp_live = row0 + warp * 16 < n_rows;
  // scores in log2 units: exp(x - m) == exp2(x log2(e) - m log2(e))
  const float scale_log2 = scale * 1.4426950408889634f;

  int n_keys = Skv;
  if (causal) {
    const int r_last = min(row0 + kTfRows, n_rows) - 1;
    n_keys = min(Skv, max(r_last / G + q_offset + 1, 0));
  }
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  for (int idx = threadIdx.x; idx < kTfRows * (D / 4); idx += blockDim.x) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    const int row = row0 + r;
    const float* src = q;
    if (row < n_rows) {
      const int qi = row / G, h = kvh * G + row % G;
      src = q + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D + c * 4;
    }
    cp_async16(q_s + r * kQS + c * 4, src, row < n_rows);
  }
  auto load_tile = [&](int t) {
    float* ks = kv_s + (t & 1) * kStage;
    float* vs = ks + kTileK;
    const int k0 = t * kKeys;
    for (int idx = threadIdx.x; idx < kKeys * (D / 4); idx += blockDim.x) {
      const int r = idx / (D / 4), c = idx % (D / 4);
      const bool live = k0 + r < Skv;
      const int64_t row =
          live ? (static_cast<int64_t>(b) * Skv + k0 + r) * K + kvh : 0;
      cp_async16(ks + r * kQS + c * 4, k + row * D + c * 4, live);
    }
    for (int idx = threadIdx.x; idx < kKeys * (DV / 4); idx += blockDim.x) {
      const int r = idx / (DV / 4), c = idx % (DV / 4);
      const bool live = k0 + r < Skv;
      const int64_t row =
          live ? (static_cast<int64_t>(b) * Skv + k0 + r) * K + kvh : 0;
      cp_async16(vs + r * kVS + c * 4, v + row * DV + c * 4, live);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  // this lane's two rows: gid and gid + 8 of the warp's 16; lim[i] = the
  // keys below it are the ones the row sees (0 past the queries or for a
  // row that sees none)
  int lim[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + gid + 8 * i;
    lim[i] = row >= n_rows ? 0
             : causal      ? min(Skv, max(row / G + q_offset + 1, 0))
                           : Skv;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // A fragments (hi, lo) of the warp's 16 rows for the two k-steps of d
  // chunk c: lane (gid, tig) reads d = 16c + 4 tig .. + 3 of rows gid and
  // gid + 8; k-step 0 takes the first two as k = tig and tig + 4, k-step 1
  // the last two
  float* q_row = q_s + (warp * 16 + gid) * kQS + 4 * tig;
  auto q_frag = [&](int c, uint32_t (&ah)[2][4], uint32_t (&al)[2][4]) {
    const float4 x = *reinterpret_cast<const float4*>(q_row + 16 * c);
    const float4 y =
        *reinterpret_cast<const float4*>(q_row + 8 * kQS + 16 * c);
    split_tf32(x.x, ah[0][0], al[0][0]);
    split_tf32(y.x, ah[0][1], al[0][1]);
    split_tf32(x.y, ah[0][2], al[0][2]);
    split_tf32(y.y, ah[0][3], al[0][3]);
    split_tf32(x.z, ah[1][0], al[1][0]);
    split_tf32(y.z, ah[1][1], al[1][1]);
    split_tf32(x.w, ah[1][2], al[1][2]);
    split_tf32(y.w, ah[1][3], al[1][3]);
  };
  uint32_t qh[kQKeep ? kDC : 1][2][4], ql[kQKeep == 2 ? kDC : 1][2][4];

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();             // tile t (and, at t = 0, Q) landed
    __syncthreads();                 // ... for every thread; tile t - 1 done
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    if (!warp_live) continue;        // rows all past the queries
    if (t == 0) {
      if constexpr (kQKeep == 2) {
#pragma unroll
        for (int c = 0; c < kDC; ++c) q_frag(c, qh[c], ql[c]);
      } else if constexpr (kQKeep == 1) {
        // each lane writes lo over the very floats it read: no other lane
        // or warp reads them
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          uint32_t al[2][4];
          q_frag(c, qh[c], al);
          *reinterpret_cast<uint4*>(q_row + 16 * c) =
              make_uint4(al[0][0], al[0][2], al[1][0], al[1][2]);
          *reinterpret_cast<uint4*>(q_row + 8 * kQS + 16 * c) =
              make_uint4(al[0][1], al[0][3], al[1][1], al[1][3]);
        }
      }
    }
    const float* ks = kv_s + (t & 1) * kStage;
    const float* vs = ks + kTileK;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      uint32_t ah[2][4], al[2][4];
      if constexpr (kQKeep == 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[h][e] = qh[c][h][e];
            al[h][e] = ql[c][h][e];
          }
      } else if constexpr (kQKeep == 1) {
        const uint4 x = *reinterpret_cast<const uint4*>(q_row + 16 * c);
        const uint4 y =
            *reinterpret_cast<const uint4*>(q_row + 8 * kQS + 16 * c);
        const uint32_t lo[2][4] = {{x.x, y.x, x.y, y.y}, {x.z, y.z, x.w, y.w}};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[h][e] = qh[c][h][e];
            al[h][e] = lo[h][e];
          }
      } else {
        q_frag(c, ah, al);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // B fragments of keys nt * 8 + gid in Q's d order
        const float4 kx = *reinterpret_cast<const float4*>(
            ks + (nt * 8 + gid) * kQS + 16 * c + 4 * tig);
        uint32_t bh[2][2], bl[2][2];
        split_tf32(kx.x, bh[0][0], bl[0][0]);
        split_tf32(kx.y, bh[0][1], bl[0][1]);
        split_tf32(kx.z, bh[1][0], bl[1][0]);
        split_tf32(kx.w, bh[1][1], bl[1][1]);
        mma_3xtf32(s[nt], ah[0], al[0], bh[0], bl[0]);
        mma_3xtf32(s[nt], ah[1], al[1], bh[1], bl[1]);
      }
    }

    const int k0 = t * kKeys;
    // only a tile that reaches past a row's last key needs the mask
    const bool masked = k0 + kKeys > min(lim[0], lim[1]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + nt * 8 + tig * 2 + j;
          const float x = !masked || key < lim[i]
                              ? s[nt][2 * i + j] * scale_log2
                              : kNegInf;
          s[nt][2 * i + j] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = fast_exp2(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = s[nt][2 * i + j];
          const float p = x > kNegInf * 0.5f ? fast_exp2(x - m_new) : 0.f;
          s[nt][2 * i + j] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }

    // P of keys kc * 8 .. + 7 as A fragments: k = tig is key 2 tig, k =
    // tig + 4 key 2 tig + 1 (S's accumulator layout)
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int kc = 0; kc < kNT; ++kc) {
      split_tf32(s[kc][0], ph[kc][0], pl[kc][0]);
      split_tf32(s[kc][2], ph[kc][1], pl[kc][1]);
      split_tf32(s[kc][1], ph[kc][2], pl[kc][2]);
      split_tf32(s[kc][3], ph[kc][3], pl[kc][3]);
    }
    const float* v0 = vs + 2 * tig * kVS + gid;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};          // this tile's P.V
#pragma unroll
      for (int kc = 0; kc < kNT; ++kc) {
        uint32_t bh[2], bl[2];
        split_tf32(v0[kc * 8 * kVS + 8 * dt], bh[0], bl[0]);
        split_tf32(v0[(kc * 8 + 1) * kVS + 8 * dt], bh[1], bl[1]);
        mma_3xtf32(pv, ph[kc], pl[kc], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dt][e] = fmaf(o[dt][e], corr[e / 2], pv[e]);
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + gid + 8 * i;
    if (row >= n_rows) continue;
    const int qi = row / G, h = kvh * G + row % G;
    float* o_row = out + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * DV;
    const float denom = fmaxf(l[i], 1e-30f);     // a row with no key: 0 / .
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<float2*>(o_row + dt * 8 + tig * 2) =
          make_float2(o[dt][2 * i] / denom, o[dt][2 * i + 1] / denom);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int H, int K,
                       int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_tf32x3_kernel<D, DV>;
  const size_t smem = tf32_smem_bytes<D, DV>();
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles =
      (static_cast<int64_t>(Sq) * (H / K) + kTfRows - 1) / kTfRows;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(tiles), K, B);
  kernel<<<grid, kTfWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, K,
      causal, scale);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int H, int K,
                        int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<D, DV>;
  const size_t smem = sizeof(bf16) * ((kMmaRows + 2 * kMmaKeys) * (D + 8) +
                                      2 * kMmaKeys * (DV + 8));
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles =
      (static_cast<int64_t>(Sq) * (H / K) + kMmaRows - 1) / kMmaRows;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(tiles), K, B);
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H, K,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k (B, Skv, K, D), v (B, Skv, K, DV), out (B, Sq, H,
// DV), all contiguous and of dtype (0 = float32, 1 = bfloat16); causal 0
// or 1. Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for a
// (D, DV) pair the file is not built for).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Skv, int H, int K, int D,
                                      int DV, int causal, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Skv < 0 || K <= 0 || H % K != 0 || K > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_CASE(DD, DDV)                                                     \
  if (D == DD && DV == DDV)                                                  \
    return dtype == 0 ? launch_f32<DD, DDV>(q, k, v, out, B, Sq, Skv, H, K,  \
                                            causal, scale, s)                \
                      : launch_bf16<DD, DDV>(q, k, v, out, B, Sq, Skv, H, K, \
                                             causal, scale, s);
  if (dtype == 0 || dtype == 1) {
    FA_CASE(32, 32) FA_CASE(64, 64) FA_CASE(128, 128) FA_CASE(256, 256)
    FA_CASE(192, 128)
  }
#undef FA_CASE
  return cudaErrorInvalidValue;
}
