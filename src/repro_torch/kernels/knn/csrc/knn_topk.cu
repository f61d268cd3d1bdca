// kNN top-k over per-query hash-grid candidate lists: for each query, the
// squared distance to each of its C candidates (invalid ones count as 1e30),
// and the K smallest, ties going to the lower candidate slot. Outputs idx
// (N, K) i32 (-1 where nothing was found) and d2 (N, K) f32 (1e30 there).
//
// Replaces the TPU kernel `_knn_kernel` / `knn_topk_call` in
// src/repro/kernels/knn/kernel.py, which runs an unrolled K-fold argmin over
// 128-query blocks of the (N, C) distance plane held in VMEM.
//
// Bound on the H100: bytes. Each candidate costs 12 B of position, 4 B of
// id and 1 B of validity read once, against 8 flops.
//
// Design: one warp per query. Lanes stride over the candidate row, so a
// warp reads consecutive candidates (coalesced), and each lane keeps its
// own sorted top-K in registers, ordered by (d2, slot). K rounds of a warp
// butterfly argmin over the lanes' heads then merge them; the winning lane
// pops its head. Ordering by (d2, slot) everywhere is the order of a stable
// sort, which is what the TPU kernel's argmin and `lax.top_k` give. The
// distance is dx*dx + dy*dy + dz*dz with rounded intrinsics, so no
// multiply-add is fused and d2 is bit-equal to the plain PyTorch version.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool before(float da, int sa, float db, int sb) {
  return da < db || (da == db && sa < sb);
}

template <int K>
__global__ void knn_topk_kernel(const float* __restrict__ q,
                                const float* __restrict__ cand_pos,
                                const int* __restrict__ cand_idx,
                                const uint8_t* __restrict__ cand_valid,
                                int* __restrict__ out_idx,
                                float* __restrict__ out_d2, int n, int c) {
  const int lane = threadIdx.x & 31;
  const int query = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (query >= n) return;  // uniform across the warp
  const float qx = q[3 * query + 0];
  const float qy = q[3 * query + 1];
  const float qz = q[3 * query + 2];
  const size_t row = static_cast<size_t>(query) * c;

  float bd[K];
  int bs[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    bd[i] = kBig;
    bs[i] = INT_MAX;
  }
  for (int j = lane; j < c; j += 32) {
    if (!cand_valid[row + j]) continue;
    const float* p = cand_pos + (row + j) * 3;
    const float dx = __fsub_rn(p[0], qx);
    const float dy = __fsub_rn(p[1], qy);
    const float dz = __fsub_rn(p[2], qz);
    float cd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz));
    if (!before(cd, j, bd[K - 1], bs[K - 1])) continue;
    int cs = j;
    // bubble the new entry into the sorted list; the displaced tail entry
    // falls off the end
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (before(cd, cs, bd[i], bs[i])) {
        const float td = bd[i];
        const int ts = bs[i];
        bd[i] = cd;
        bs[i] = cs;
        cd = td;
        cs = ts;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < K; ++r) {
    float d = bd[0];
    int s = bs[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, off);
      const int os = __shfl_xor_sync(kFull, s, off);
      if (before(od, os, d, s)) {
        d = od;
        s = os;
      }
    }
    // every lane holds the winner; slot s lives in lane s % 32
    if (s != INT_MAX && (s & 31) == lane) {
#pragma unroll
      for (int i = 0; i + 1 < K; ++i) {
        bd[i] = bd[i + 1];
        bs[i] = bs[i + 1];
      }
      bd[K - 1] = kBig;
      bs[K - 1] = INT_MAX;
    }
    if (lane == 0) {
      const bool found = d < 0.5f * kBig;
      out_idx[static_cast<size_t>(query) * K + r] =
          found ? cand_idx[row + s] : -1;
      out_d2[static_cast<size_t>(query) * K + r] = found ? d : kBig;
    }
  }
}

constexpr int kWarpsPerBlock = 8;
constexpr int kK = 6;  // GNNConfig.k_neighbors, the only k the path uses

}  // namespace

// q (n, 3) f32, cand_pos (n, c, 3) f32, cand_idx (n, c) i32, cand_valid
// (n, c) bool as bytes, out_idx (n, 6) i32, out_d2 (n, 6) f32, all
// contiguous; c >= 6. Returns cudaGetLastError().
extern "C" int knn_topk_f32(const void* q, const void* cand_pos,
                            const void* cand_idx, const void* cand_valid,
                            void* out_idx, void* out_d2, int n, int c,
                            void* stream) {
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  knn_topk_kernel<kK><<<grid, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cand_pos),
      static_cast<const int*>(cand_idx),
      static_cast<const uint8_t*>(cand_valid), static_cast<int*>(out_idx),
      static_cast<float*>(out_d2), n, c);
  return static_cast<int>(cudaGetLastError());
}
