// Flash attention with GQA, causal masking, a sliding window and a tanh
// logit softcap, for head_dim 256 in f32 on the CUDA cores:
//   out[bh, i] = softmax_j(mask(cap(q[bh, i] . k[bh / group, j] / sqrt(hd))))
//                . v[bh / group, j]
// with the mask j <= i (causal) and i - j < window, f32 throughout. q, k, v,
// out are (rows, S, 256), contiguous; Skv == Sq. bf16 goes to the tensor-core
// kernel in flash_attention_wgmma.cu; f32 stays here because the tensor
// cores' TF32 keeps about three digits and the f32 path is held to 1e-5.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py, which walks (128, hd) query
// blocks over a sequential grid axis of (128, hd) key blocks on the MXU and
// keeps the running max, denominator and accumulator in VMEM scratch.
//
// Bound on the H100: operations. 4 * hd flops per unmasked (query, key)
// pair; at gemma2's prefill shape that is about 3.5e11 flops, 5.2 ms at the
// CUDA cores' 67 TFLOP/s in f32, against 450 MB of q, k, v and out.
//
// Design: one warp per query row, 16 rows of one (batch, head) per block.
// Each lane holds 8 of the row's 256 dims of q and of the f32 accumulator.
// The block stages 64-key tiles of K and V in dynamic shared memory (128 KB)
// and skips tiles wholly past the causal diagonal or before the window; each
// warp also skips the 32-key chunks that are wholly masked for its row. Per
// chunk, every lane forms its 8-dim partial dot with each of the 32 keys,
// and a reduce-scatter butterfly (31 shuffles) leaves lane t with the full
// score of key t. The online softmax then takes one max and one sum over the
// warp per chunk, and the PV update broadcasts each key's probability to the
// lanes, which add it times their 8 dims of v.
// Masked logits are -1e30, never -inf, as in the TPU kernel: a chunk that is
// wholly masked for a row before its first real key gives p = 1 for its
// keys, and that is wiped by alpha = exp(-1e30 - m) = 0 when the real keys
// arrive. Keys past S are zero in shared memory, so no garbage is read.
// expf and tanhf (not the fast intrinsics) keep f32 within about 1e-6 of
// the plain PyTorch version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHd = 256;        // gemma2's head_dim, the only one on the path
constexpr int kRows = 16;       // query rows (warps) per block
constexpr int kTile = 64;       // keys per shared-memory tile
constexpr int kChunk = 32;      // keys per online-softmax step, one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Lane owns dims [4 * lane, 4 * lane + 4) and [128 + 4 * lane, ...), two
// 16-byte accesses with neighbouring lanes on neighbouring addresses.
__device__ __forceinline__ void load_row(const float* row, int lane,
                                         float* x) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * lane);
  const float4 b = *reinterpret_cast<const float4*>(row + 128 + 4 * lane);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store_row(float* row, int lane,
                                          const float* x) {
  *reinterpret_cast<float4*>(row + 4 * lane) =
      make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(row + 128 + 4 * lane) =
      make_float4(x[4], x[5], x[6], x[7]);
}

// One stage of the reduce-scatter: lanes with bit N set keep the upper N
// of their 2N partial sums, the others the lower N, each adding its
// partner's copy of the half it keeps.
template <int N>
__device__ __forceinline__ void reduce_scatter_stage(float* v, int lane) {
  const bool upper = (lane & N) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? v[i] : v[i + N];
    const float keep = upper ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, N);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__global__ void __launch_bounds__(kRows * 32)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int group,
             int s, int causal, int window, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kTile * kHd;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  // the last row blocks carry the most keys under causal masking: start them
  // first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int r_last = min(r0 + kRows, s) - 1;
  const int row = r0 + (threadIdx.x >> 5);
  const bool active = row < s;  // uniform across the warp
  const size_t kv_base = static_cast<size_t>(bh / group) * s * kHd;

  float qr[8], acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    qr[i] = 0.f;
    acc[i] = 0.f;
  }
  if (active) load_row(q + (static_cast<size_t>(bh) * s + row) * kHd, lane, qr);
  float m = kNegInf, l = 0.f;

  const int lo = window > 0 ? max(0, r0 - window + 1) : 0;
  const int hi = causal ? r_last + 1 : s;  // keys [lo, hi) reach the block
  constexpr int kVecPerRow = kHd * 4 / 16;
  for (int t0 = lo / kTile * kTile; t0 < hi; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < kTile * kVecPerRow; idx += blockDim.x) {
      const int r = idx / kVecPerRow, c = idx % kVecPerRow;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (t0 + r < s) {
        const size_t off = kv_base + static_cast<size_t>(t0 + r) * kHd;
        kk = reinterpret_cast<const uint4*>(k + off)[c];
        vv = reinterpret_cast<const uint4*>(v + off)[c];
      }
      reinterpret_cast<uint4*>(ks + r * kHd)[c] = kk;
      reinterpret_cast<uint4*>(vs + r * kHd)[c] = vv;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      const int kb = t0 + c0;  // first key of the chunk
      if (kb >= s || (causal && kb > row)) break;
      if (window > 0 && row - (kb + kChunk - 1) >= window) continue;
      float part[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        float kr[8];
        load_row(ks + (c0 + t) * kHd, lane, kr);
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qr[i], kr[i], d);
        part[t] = d;
      }
      reduce_scatter_stage<16>(part, lane);
      reduce_scatter_stage<8>(part, lane);
      reduce_scatter_stage<4>(part, lane);
      reduce_scatter_stage<2>(part, lane);
      reduce_scatter_stage<1>(part, lane);
      // part[0] is now the score of key kb + lane
      const int j = kb + lane;
      float sc = part[0] * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      const bool ok = j < s && (!causal || j <= row) &&
                      (window <= 0 || row - j < window);
      if (!ok) sc = kNegInf;
      const float m_new = fmaxf(m, warp_max(sc));
      const float alpha = expf(m - m_new);
      const float p = expf(sc - m_new);
      l = l * alpha + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] *= alpha;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const float pt = __shfl_sync(kFull, p, t);
        float vr[8];
        load_row(vs + (c0 + t) * kHd, lane, vr);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(pt, vr[i], acc[i]);
      }
    }
  }
  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = acc[i] / denom;
    store_row(out + (static_cast<size_t>(bh) * s + row) * kHd, lane, acc);
  }
}

}  // namespace

// q, out (bh, s, hd); k, v (bh / group, s, hd); f32, contiguous and 16-byte
// aligned; hd == 256. window <= 0: none; softcap <= 0: none. Returns a
// cudaError_t (cudaErrorInvalidValue for a shape the kernel is not built for).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int bh, int group,
                                   int s, int causal, int window, int hd,
                                   float scale, float softcap, void* stream) {
  if (hd != kHd || group < 1 || bh < 1 || bh % group || bh > 65535 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * kTile * kHd * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kRows - 1) / kRows, bh);
  flash_kernel<<<grid, kRows * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), group, s, causal,
      window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}
