// Paged K/V write for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package writes a step's new cache
// entries into its page pool with an XLA scatter (attn_step_paged_ragged
// and its int8 and MLA twins in src/repro/models/attention.py,
// `pool.at[phys, slot].set(..., mode="drop")`). In PyTorch, boolean-mask
// indexing would read each `nonzero`'s count back to the host, four times
// a layer, and so drain the card's queue in every layer of a serving step.
// This kernel works out each slot's target on the card and drops the slots
// it must not write: the write makes no host sync at all.
//
// A step's B x Q slots, each with a position, a valid flag and one row of
// every plane (1 to 4 planes: k and v; int8 codes and their bf16 scales;
// the MLA latent and rope key), already cast to the planes' dtypes. Slot
// (b, i) at position p goes to page table[b, clamp(p // T, 0, MP - 1)],
// slot p mod T (floor division, as torch's // and %), of every plane, if
// it is valid and that table entry is a real page (0 <= page < P); any
// other slot touches nothing, as JAX's mode="drop" (a padding slot, a row
// with q_len 0, a table entry of -1 or past the pool). Two written slots
// aimed at one target (only positions clamped past the table can be)
// leave one of them, which one unspecified, as for the boolean-index write
// on the card and JAX's scatter.
//
// Bound: bytes, and at a serving step's sizes the launch itself. Each
// written slot reads and writes its rows once (K and V of one InternLM2
// token: 2 x 2048 B) and reads one table entry; every slot reads its flag
// and position. A chat tick (64 x 128 slots, 445 written): 3.7 MB, 1.1 us
// at 3.35 TB/s, below one launch's cost.
//
// Design: one warp a slot, four slots a block; the warp works out its
// slot's target, leaves at once if the slot is dropped, and copies each
// plane's row with its 32 lanes on neighbouring addresses, 16 bytes a lane
// where the row's size and both base pointers allow, else the widest of
// 8, 4, 2, 1 that they allow (chosen on the host, once a plane). The time
// is latency: a written slot waits on its flag and position, then its
// table entry, then its rows, so each lane keeps four loads in flight
// before it stores (an InternLM2 K row is 128 16-byte units: one round).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 4;
constexpr int kWarps = 4;           // slots a block, one a warp
constexpr int kUnroll = 4;

struct Planes {
  char* pool[kMaxPlanes];
  const char* val[kMaxPlanes];
  int64_t row_bytes[kMaxPlanes];    // bytes of one slot's row
  int unit[kMaxPlanes];             // bytes a lane moves at once
  int n;
};

// a row's units, kUnroll loads in flight a lane before their stores
template <typename U>
__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         int64_t bytes, int lane) {
  U* d = reinterpret_cast<U*>(dst);
  const U* s = reinterpret_cast<const U*>(src);
  const int64_t n = bytes / static_cast<int64_t>(sizeof(U));
  for (int64_t base = lane; base < n; base += 32 * kUnroll) {
    U r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * 32 < n) r[u] = s[base + u * 32];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * 32 < n) d[base + u * 32] = r[u];
  }
}

__global__ void __launch_bounds__(kWarps * 32) kv_page_write_kernel(
    Planes planes, const int32_t* __restrict__ table,
    const int64_t* __restrict__ positions,
    const uint8_t* __restrict__ valid, int64_t N, int Q, int MP, int P,
    int T) {
  const int64_t n =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const bool ok = valid[n] != 0;    // both loads in flight at once
  const int64_t pos = positions[n];
  if (!ok) return;
  int64_t logical = pos / T;
  int64_t slot = pos - logical * T;
  if (slot < 0) {                   // floor division for a negative p
    logical -= 1;
    slot += T;
  }
  logical = logical < 0 ? 0 : (logical >= MP ? MP - 1 : logical);
  const int32_t page = table[(n / Q) * MP + logical];
  if (page < 0 || page >= P) return;
  const int64_t row = static_cast<int64_t>(page) * T + slot;
  for (int j = 0; j < planes.n; ++j) {
    const int64_t bytes = planes.row_bytes[j];
    char* dst = planes.pool[j] + row * bytes;
    const char* src = planes.val[j] + n * bytes;
    switch (planes.unit[j]) {
      case 16: copy_row<uint4>(dst, src, bytes, lane); break;
      case 8: copy_row<uint2>(dst, src, bytes, lane); break;
      case 4: copy_row<uint32_t>(dst, src, bytes, lane); break;
      case 2: copy_row<uint16_t>(dst, src, bytes, lane); break;
      default: copy_row<uint8_t>(dst, src, bytes, lane); break;
    }
  }
}

// the widest of 16, 8, 4, 2, 1 bytes that divides the row and both bases
int unit_of(const void* pool, const void* val, int64_t row_bytes) {
  const uint64_t bits = reinterpret_cast<uintptr_t>(pool) |
                        reinterpret_cast<uintptr_t>(val) |
                        static_cast<uint64_t>(row_bytes) | 16u;
  return static_cast<int>(bits & (~bits + 1));   // lowest set bit
}

}  // namespace

// table (B, MP) int32, positions (B, Q) int64, valid (B, Q) bool (one byte
// a flag); plane j: pool_j (P, T, ...) and val_j (B, Q, ...) of one dtype,
// row_bytes_j the bytes of one slot's row; planes past n_planes are
// ignored; all contiguous, on one device. Launches on `stream` and returns
// a cudaError_t (0 = launched).
extern "C" int kv_page_write_launch(
    const void* table, const void* positions, const void* valid,
    void* pool0, void* pool1, void* pool2, void* pool3, const void* val0,
    const void* val1, const void* val2, const void* val3,
    long long row_bytes0, long long row_bytes1, long long row_bytes2,
    long long row_bytes3, int n_planes, int B, int Q, int MP, int P, int T,
    void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || B < 0 || Q < 0 || MP <= 0 ||
      P < 0 || T <= 0)
    return cudaErrorInvalidValue;
  const int64_t N = static_cast<int64_t>(B) * Q;
  if (N == 0) return cudaSuccess;
  void* pools[kMaxPlanes] = {pool0, pool1, pool2, pool3};
  const void* vals[kMaxPlanes] = {val0, val1, val2, val3};
  const long long bytes[kMaxPlanes] = {row_bytes0, row_bytes1, row_bytes2,
                                       row_bytes3};
  Planes planes{};
  planes.n = n_planes;
  for (int j = 0; j < n_planes; ++j) {
    if (bytes[j] <= 0) return cudaErrorInvalidValue;
    planes.pool[j] = static_cast<char*>(pools[j]);
    planes.val[j] = static_cast<const char*>(vals[j]);
    planes.row_bytes[j] = bytes[j];
    planes.unit[j] = unit_of(pools[j], vals[j], bytes[j]);
  }
  const int64_t blocks = (N + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kv_page_write_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      planes, static_cast<const int32_t*>(table),
      static_cast<const int64_t*>(positions),
      static_cast<const uint8_t*>(valid), N, Q, MP, P, T);
  return cudaGetLastError();
}
