// kNN top-k over per-query hash-grid candidate lists: for each query, the
// squared distance to each of its C candidates (invalid ones count as 1e30),
// and the K smallest, ties going to the lower candidate slot. Outputs idx
// (N, K) i32 (-1 where nothing was found) and d2 (N, K) f32 (1e30 there).
//
// Replaces the TPU kernel `_knn_kernel` / `knn_topk_call` in
// src/repro/kernels/knn/kernel.py, which runs an unrolled K-fold argmin over
// 128-query blocks of the (N, C) distance plane held in VMEM.
//
// Bound on the H100: bytes. Each candidate costs 1 B of validity; each valid
// one 12 B of position; each winner 4 B of id; against 8 flops a candidate.
// On the serving path a row's valid slots are a prefix (the candidates of
// the query's 27 cells, minus the query itself) and its tail, about half the
// row, is invalid padding.
//
// Design: one warp per query, and two dependent round trips to memory per
// query, of which a warp waits on about one. The row is cut into chunks of
// 128 slots, and each lane owns 4 consecutive slots of every chunk: their
// validity is one 32-bit load and their positions three float4 loads (48 B),
// so a warp reads a chunk as 128 B and 1,536 B, neighbouring lanes on
// neighbouring addresses.
//   (a) The validity words of the row's first 4 chunks are loaded at once
//       (the rest, for C > 512, in one more round trip), and the last valid
//       slot found with a warp max-reduce.
//   (b) Every position up to that slot is loaded, two chunks at a time (all
//       of a 256-slot row), before any arithmetic. Lanes whose slots all lie
//       past the last valid one load nothing, so the invalid tail costs its
//       validity bytes only.
// The grid is persistent (one wave of resident blocks), and a warp walks its
// queries so that (a) of the next query is issued right behind (b) of this
// one, and this query's outputs are stored behind the next query's loads:
// a warp waits on memory about once a query, not three times.
// Each lane keeps its own sorted top-K in registers as 64-bit keys
// (d2's bits << 32 | slot): d2 >= 0, so the key order is the (d2, slot)
// order, which is a stable sort's and what the TPU kernel's argmin and
// `lax.top_k` give. K rounds of two warp min-reduces (d2, then slot among
// the lanes holding that d2) merge the lanes' heads; the one lane holding the
// winner pops it, and lane r keeps round r's winner, so that at the end lanes
// 0..K-1 each read one winner's id and store one output, all at once. The
// distance is dx*dx + dy*dy + dz*dz with rounded intrinsics, so no multiply-
// add is fused and d2 is bit-equal to the plain PyTorch version.
//
// Rows are 16-byte aligned when C % 4 == 0 (every C on the serving path is a
// multiple of 128); otherwise, or for a misaligned pointer, the same kernel
// reads each lane's 4 slots with scalar loads.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;  // after every real key
constexpr int kChunk = 128;      // slots a warp reads per chunk: 4 a lane
constexpr int kPrefetch = 4;     // validity words of a row a lane loads at once
constexpr int kGroup = 2;        // chunks whose positions are in flight at once
constexpr int kWarpsPerBlock = 8;
constexpr int kK = 6;  // GNNConfig.k_neighbors, the only k the path uses

// Validity of slots s0..s0+3 as one word, byte i for slot s0 + i (nonzero:
// valid); slots at or past c read as invalid.
template <bool kVec>
__device__ __forceinline__ uint32_t load_valid(const uint8_t* row, int s0,
                                               int c) {
  if constexpr (kVec)
    return s0 < c ? __ldg(reinterpret_cast<const uint32_t*>(row + s0)) : 0u;
  else {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (s0 + i < c && __ldg(row + s0 + i)) v |= 1u << (8 * i);
    return v;
  }
}

// Positions of slots s0..s0+3: p[3 i + j] is coordinate j of slot s0 + i.
template <bool kVec>
__device__ __forceinline__ void load_pos(const float* row, int s0, int c,
                                         float (&p)[12]) {
  if constexpr (kVec) {
    const float4* src = reinterpret_cast<const float4*>(row + 3 * s0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 f = __ldg(src + i);
      p[4 * i + 0] = f.x;
      p[4 * i + 1] = f.y;
      p[4 * i + 2] = f.z;
      p[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i)
      p[i] = s0 + i / 3 < c ? __ldg(row + 3 * s0 + i) : 0.0f;
  }
}

// What a warp needs first of a query: its position and the validity words of
// its first kPrefetch chunks (4 slots a lane each).
struct Head {
  float x, y, z;
  uint32_t valid[kPrefetch];
};

template <bool kVec>
__device__ __forceinline__ void load_head(const float* q,
                                          const uint8_t* row_valid, int query,
                                          int c, int lane, Head& h) {
  h.x = __ldg(q + 3 * query + 0);
  h.y = __ldg(q + 3 * query + 1);
  h.z = __ldg(q + 3 * query + 2);
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i)
    h.valid[i] = load_valid<kVec>(row_valid, i * kChunk + 4 * lane, c);
}

// The row's last valid slot (-1 for none), the same in every lane.
template <bool kVec>
__device__ __forceinline__ int last_valid(const Head& h,
                                          const uint8_t* row_valid, int c,
                                          int lane) {
  int last = -1;
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i)
    if (h.valid[i])
      last = i * kChunk + 4 * lane + ((31 - __clz(h.valid[i])) >> 3);
  // rows longer than the prefetch: the rest in one more round trip
  for (int ch0 = kPrefetch; ch0 * kChunk < c; ch0 += kPrefetch) {
    uint32_t v[kPrefetch];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i)
      v[i] = load_valid<kVec>(row_valid, (ch0 + i) * kChunk + 4 * lane, c);
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i)
      if (v[i])
        last = (ch0 + i) * kChunk + 4 * lane + ((31 - __clz(v[i])) >> 3);
  }
  return static_cast<int>(
             __reduce_max_sync(kFull, static_cast<unsigned>(last + 1))) - 1;
}

// The positions and validity of a lane's slots in chunks ch0..ch0+kGroup-1,
// for the chunks it holds a slot <= last of (validity 0 elsewhere).
template <bool kVec>
__device__ __forceinline__ void load_group(const float* row_pos,
                                           const uint8_t* row_valid, int ch0,
                                           int last, int c, int lane,
                                           float (&p)[kGroup][12],
                                           uint32_t (&v)[kGroup]) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int s0 = (ch0 + g) * kChunk + 4 * lane;
    v[g] = 0;
    if (s0 <= last) {
      v[g] = load_valid<kVec>(row_valid, s0, c);
      load_pos<kVec>(row_pos, s0, c, p[g]);
    }
  }
}

// d2 of the group's valid slots, each inserted into the lane's sorted keys
// (the last key falls off).
template <int K>
__device__ __forceinline__ void scan_group(const float (&p)[kGroup][12],
                                           const uint32_t (&v)[kGroup],
                                           int ch0, int lane, float qx,
                                           float qy, float qz,
                                           unsigned long long (&best)[K]) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!((v[g] >> (8 * i)) & 0xffu)) continue;
      const float dx = __fsub_rn(p[g][3 * i + 0], qx);
      const float dy = __fsub_rn(p[g][3 * i + 1], qy);
      const float dz = __fsub_rn(p[g][3 * i + 2], qz);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const unsigned slot = (ch0 + g) * kChunk + 4 * lane + i;
      unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | slot;
      if (key >= best[K - 1]) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const unsigned long long lo = key < best[j] ? key : best[j];
        key = key < best[j] ? best[j] : key;
        best[j] = lo;
      }
    }
  }
}

// Warp w takes queries w, w + stride, ...
template <int K, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    knn_topk_kernel(const float* __restrict__ q,
                    const float* __restrict__ cand_pos,
                    const int* __restrict__ cand_idx,
                    const uint8_t* __restrict__ cand_valid,
                    int* __restrict__ out_idx, float* __restrict__ out_d2,
                    int n, int c) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarpsPerBlock;
  int query = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (query >= n) return;  // uniform across the warp
  Head head;
  load_head<kVec>(q, cand_valid + static_cast<size_t>(query) * c, query, c,
                  lane, head);
  // lane r < K holds the previous query's r-th output until it is stored
  size_t out_at = SIZE_MAX;
  int out_id = -1;
  float out_dist = kBig;
  for (;;) {
    const size_t row = static_cast<size_t>(query) * c;
    const uint8_t* row_valid = cand_valid + row;
    const float* row_pos = cand_pos + 3 * row;
    const float qx = head.x, qy = head.y, qz = head.z;
    const int last = last_valid<kVec>(head, row_valid, c, lane);
    const int next = query + stride;

    // (b) positions up to the last valid slot, kGroup chunks at a time;
    // the first group's loads go out before the next query's head
    unsigned long long best[K];
#pragma unroll
    for (int i = 0; i < K; ++i) best[i] = kEmpty;
    float p[kGroup][12];
    uint32_t v[kGroup];
    load_group<kVec>(row_pos, row_valid, 0, last, c, lane, p, v);
    if (next < n)
      load_head<kVec>(q, cand_valid + static_cast<size_t>(next) * c, next,
                      c, lane, head);
    scan_group<K>(p, v, 0, lane, qx, qy, qz, best);
    if (out_at != SIZE_MAX) {  // the previous query's ids have landed
      out_idx[out_at] = out_id;
      out_d2[out_at] = out_dist;
    }
    for (int ch0 = kGroup; ch0 * kChunk <= last; ch0 += kGroup) {
      load_group<kVec>(row_pos, row_valid, ch0, last, c, lane, p, v);
      scan_group<K>(p, v, ch0, lane, qx, qy, qz, best);
    }

    // merge: round r takes the least head over the lanes (d2, then slot
    // among the lanes holding that d2); its lane pops it, lane r keeps it
    unsigned mine_d = UINT_MAX, mine_s = UINT_MAX;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const unsigned hd = static_cast<unsigned>(best[0] >> 32);
      const unsigned hs = static_cast<unsigned>(best[0]);
      const unsigned md = __reduce_min_sync(kFull, hd);
      const unsigned ms = __reduce_min_sync(kFull, hd == md ? hs : UINT_MAX);
      if (lane == r) {
        mine_d = md;
        mine_s = ms;
      }
      if (hd == md && hs == ms) {  // one lane, or all once every list is empty
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) best[j] = best[j + 1];
        best[K - 1] = kEmpty;
      }
    }
    if (lane < K) {
      const float d = __uint_as_float(mine_d);
      const bool found = d < 0.5f * kBig;  // an empty key's d2 is a NaN
      out_at = static_cast<size_t>(query) * K + lane;
      out_id = found ? __ldg(cand_idx + row + mine_s) : -1;
      out_dist = found ? d : kBig;
    }
    if (next >= n) break;
    query = next;
  }
  if (out_at != SIZE_MAX) {
    out_idx[out_at] = out_id;
    out_d2[out_at] = out_dist;
  }
}

}  // namespace

// q (n, 3) f32, cand_pos (n, c, 3) f32, cand_idx (n, c) i32, cand_valid
// (n, c) bool as bytes, out_idx (n, 6) i32, out_d2 (n, 6) f32, all
// contiguous. Returns cudaGetLastError().
extern "C" int knn_topk_f32(const void* q, const void* cand_pos,
                            const void* cand_idx, const void* cand_valid,
                            void* out_idx, void* out_d2, int n, int c,
                            void* stream) {
  const bool vec = c % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(cand_pos) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cand_valid) % 4 == 0;
  const auto kernel =
      vec ? knn_topk_kernel<kK, true> : knn_topk_kernel<kK, false>;
  const int block = 32 * kWarpsPerBlock;
  // one wave of resident blocks, or fewer for a small n
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
  const int needed = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int grid = sms * per_sm > 0 && sms * per_sm < needed ? sms * per_sm
                                                             : needed;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cand_pos),
      static_cast<const int*>(cand_idx),
      static_cast<const uint8_t*>(cand_valid), static_cast<int*>(out_idx),
      static_cast<float*>(out_d2), n, c);
  return static_cast<int>(cudaGetLastError());
}
