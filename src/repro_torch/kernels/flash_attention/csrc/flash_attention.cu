// Flash attention with GQA, causal masking, a sliding window and a tanh
// logit softcap, for head_dim 128 or 256 in f32 on the CUDA cores:
//   out[bh, i] = softmax_j(mask(cap(q[bh, i] . k[bh / group, j] / sqrt(hd))))
//                . v[bh / group, j]
// with the mask j <= i (causal) and i - j < window, f32 throughout. q, k, v,
// out are (rows, S, hd), contiguous; Skv == Sq. The kernel is a template on
// hd with one instance for each head_dim on the path, 256 (gemma2) and 128
// (the llama-style and MoE decoders). bf16 goes to the tensor-core
// kernel in flash_attention_wgmma.cu; f32 stays here because the tensor
// cores' TF32 keeps about three digits and the f32 path is held to 1e-5.
// Every product is an IEEE f32 FMA; no TF32, bf16 or library call.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py, which walks (128, hd) query
// blocks over a sequential grid axis of (128, hd) key blocks on the MXU and
// keeps the running max, denominator and accumulator in VMEM scratch.
//
// Bound on the H100: operations. 4 * hd flops per unmasked (query, key)
// pair; at gemma2's prefill shape that is about 3.5e11 flops, 5.2 ms at the
// CUDA cores' 67 TFLOP/s in f32, against 450 MB of q, k, v and out. An SM
// issues 128 FMAs a clock but reads only 128 bytes a clock from shared
// memory, so every float a thread reads has to feed several FMAs from
// registers.
//
// Design: a register-tiled SIMT product, as in an sgemm. One block of 256
// threads (8 warps) owns 64 query rows of one (batch, head) and walks 64-key
// tiles of K and V. Shared memory (219,648 bytes at hd 256, 121,344 at hd
// 128; one block per SM) holds Q (staged once), one K tile, one V tile, the
// tile's P, and each row's rescale factor and denominator. Q and K rows are
// padded to hd + 8 floats (8 words apart in the banks), P rows to 72, so
// that the 16-byte reads below hit distinct banks.
// - S = Q K^T: each thread owns an 8 x 4 tile of S (8 rows, keys 8 apart)
//   over half of the dims (dims 8m + 4 dh + [0, 4), dh the lane's low bit),
//   at either hd,
//   so 8 LDS.128 of Q and 4 of K feed 128 FMAs; one shuffle per kept score
//   adds the partner lane's half (a reduce-scatter: each lane keeps 4 rows).
// - Scale, softcap (tanhf), then mask with -1e30 (only on a tile that
//   crosses S, the diagonal or the window's edge); S goes to shared memory.
// - Online softmax: 4 threads per row, 16 keys each, 2 shuffles for the
//   max and 2 for the sum (expf, not the fast intrinsic); p back in place,
//   the row's rescale factor and running denominator beside it.
// - O = alpha O + P V: each thread keeps an 8 x 4 hd / 128 tile of the
//   (64, hd) output (rows r + 4i of a warp's 32, hd / 128 runs of 4
//   columns, 32 apart, of the warp's hd / 4) and walks the 64 keys 4 at a
//   time. At hd 256 the tile is 8 x 8 in 64 registers, and 8 LDS.128 of P
//   and 8 of V feed 256 FMAs; at hd 128 the thread map is the same and the
//   tile is 8 x 4 (one run), so 8 LDS.128 of P and 4 of V feed 128 FMAs.
// - cp.async double duty: V of a tile streams in while S is computed, the
//   next K tile while the softmax and PV run, so no extra buffer is needed
//   to overlap the L2 reads with the FMAs. Rows past S are zero-filled.
// - The block's key range skips tiles wholly past the causal diagonal or
//   before the window; blocks start from the last (longest) row block.
// On the H100 the kernel takes about twice its bound (PERF.md; the parts
// are timed by ablate.py): the shared-memory reads and the instructions
// around the FMAs hold it there. A 4 x 4 tile of S over all the dims was
// slower, an 8 x 8 tile over a quarter of them spilled registers, and 512
// threads with smaller tiles were slower still.
// Masked logits are -1e30, never -inf, as in the TPU kernel: a tile that is
// wholly masked for a row before its first real key gives p = 1 for its
// keys, and that is wiped by alpha = exp(-1e30 - m) = 0 when the real keys
// arrive. expf and tanhf (not the fast intrinsics) keep f32 within about
// 1e-6 of the plain PyTorch version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;       // query rows per block
constexpr int kKeys = 64;       // keys per K/V tile
constexpr int kThreads = 256;
constexpr int kPStride = kKeys + 8;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kKeys == kRows, "load_tile copies 64-row tiles of Q, K, V");

// shared memory at head_dim kHd, in floats
template <int kHd>
struct Layout {
  static constexpr int kQkStride = kHd + 8;  // floats per Q or K row
  static constexpr int kVStride = kHd;
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kRows * kQkStride;
  static constexpr int kVOff = kKOff + kKeys * kQkStride;
  static constexpr int kPOff = kVOff + kKeys * kVStride;
  static constexpr int kAlphaOff = kPOff + kRows * kPStride;
  static constexpr int kLOff = kAlphaOff + kRows;
  static constexpr int kSmemBytes =
      (kLOff + kRows) * static_cast<int>(sizeof(float));
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may take");
};

// 16 bytes from global to shared memory, asynchronously; zeros if !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Rows [r0, r0 + 64) of a (s, hd) matrix into shared memory at the given
// row stride, 16 bytes a copy, neighbouring threads on neighbouring
// addresses; rows past s are zero-filled (and read row 0, a valid address).
template <int kHd>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, int r0, int s) {
  constexpr int kVec = kHd / 4;
#pragma unroll
  for (int n = 0; n < kRows * kVec / kThreads; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    const int r = idx / kVec, c = idx % kVec;
    const bool valid = r0 + r < s;
    cp_async16(dst + r * stride + 4 * c,
               src + static_cast<size_t>(valid ? r0 + r : 0) * kHd + 4 * c,
               valid);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int kHd>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int group,
             int s, int causal, int window, float scale, float softcap) {
  using L = Layout<kHd>;
  constexpr int kQkStride = L::kQkStride, kVStride = L::kVStride;
  constexpr int kRuns = kHd / 128;  // runs of 4 output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::kQOff;
  float* ks = smem + L::kKOff;
  float* vs = smem + L::kVOff;
  float* ps = smem + L::kPOff;
  float* alpha_s = smem + L::kAlphaOff;
  float* l_s = smem + L::kLOff;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  // the last row blocks carry the most keys under causal masking: start them
  // first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int r_last = min(r0 + kRows, s) - 1;
  const size_t kv_base = static_cast<size_t>(bh / group) * s * kHd;
  const float* kg = k + kv_base;
  const float* vg = v + kv_base;

  // S layout: warp w owns rows 16 (w / 2) + [0, 16) and keys 32 (w % 2) +
  // [0, 32) as 2 x 8 tiles of 8 rows x 4 keys, each tile on 2 lanes, one per
  // half dh of the dims. Lane bits: dh = 0, the tile's key offset = 1-3, its
  // row half = 4. The thread's rows are s_row + [0, 8), its keys s_key + 8j,
  // j < 4, its dims 8m + 4 dh + [0, 4), m < hd / 8. So the 8 lanes of a
  // quarter-warp (one phase of a 16-byte read) read Q at one row in 2
  // words, and K at 4 neighbouring keys, whose rows sit hd + 8 floats (8
  // banks) apart: 8 distinct bank groups.
  const int dh = lane & 1;
  const int s_row = 16 * (warp >> 1) + 8 * (lane >> 4);
  const int s_key = 32 * (warp & 1) + ((lane >> 1) & 7);
  // O layout: warp w owns rows 32 (w / 4) + [0, 32) and columns hd / 4
  // (w % 4) + [0, hd / 4); the thread rows o_row + 4i, i < 8, columns
  // o_col + 32 r + [0, 4), r < kRuns
  const int o_row = 32 * (warp >> 2) + (lane & 3);
  const int o_col = kHd / 4 * (warp & 3) + 4 * (lane >> 2);
  // softmax layout: 4 threads per row, 16 keys each
  const int m_row = tid >> 2, m_part = tid & 3;

  float o[8][4 * kRuns];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kRuns; ++c) o[i][c] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // of row m_row, in all 4 threads

  const int lo = window > 0 ? max(0, r0 - window + 1) : 0;
  const int hi = causal ? r_last + 1 : s;  // keys [lo, hi) reach the block
  const int t_first = lo / kKeys * kKeys;
  load_tile<kHd>(qs, kQkStride, q + static_cast<size_t>(bh) * s * kHd, r0,
                 s);
  load_tile<kHd>(ks, kQkStride, kg, t_first, s);
  cp_async_commit();

  for (int t0 = t_first; t0 < hi; t0 += kKeys) {
    load_tile<kHd>(vs, kVStride, vg, t0, s);  // lands during S
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q and this K tile are in shared memory

    // S: 32 partial sums of an 8 x 4 tile over half of the dims, then a
    // reduce-scatter with the lane that holds the other half
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 4 * dh; d < kHd; d += 8) {
      float4 qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = lds4(qs + (s_row + i) * kQkStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv = lds4(ks + (s_key + 8 * j) * kQkStride + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(qv[i].x, kv.x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, kv.y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, kv.z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, kv.w, acc[i][j]);
        }
      }
    }
    // the lane with dh = 1 keeps rows 4-7, its partner rows 0-3: this lane
    // ends with the full scores of rows s_row + 4 dh + [0, 4)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float send = dh ? acc[i][j] : acc[i + 4][j];
        const float keep = dh ? acc[i + 4][j] : acc[i][j];
        acc[i][j] = keep + __shfl_xor_sync(kFull, send, 1);
      }
    // a tile that crosses S, the diagonal or the window's edge is masked
    const bool edge = t0 + kKeys > s || (causal && t0 + kKeys - 1 > r0) ||
                      (window > 0 && r0 + kRows - 1 - t0 >= window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + s_row + 4 * dh + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + s_key + 8 * j;
        float x = acc[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge && !(key < s && (!causal || key <= row) &&
                      (window <= 0 || row - key < window)))
          x = kNegInf;
        ps[(s_row + 4 * dh + i) * kPStride + s_key + 8 * j] = x;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // S is in shared memory, V has landed, K is free
    if (t0 + kKeys < hi) load_tile<kHd>(ks, kQkStride, kg, t0 + kKeys, s);
    cp_async_commit();  // lands during the softmax and PV

    {
      float* prow = ps + m_row * kPStride + 16 * m_part;
      float x[16];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 t = lds4(prow + 4 * c);
        x[4 * c] = t.x;
        x[4 * c + 1] = t.y;
        x[4 * c + 2] = t.z;
        x[4 * c + 3] = t.w;
      }
      float mx = x[0];
#pragma unroll
      for (int c = 1; c < 16; ++c) mx = fmaxf(mx, x[c]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        x[c] = expf(x[c] - m_new);
        sum += x[c];
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(prow + 4 * c) =
            make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
      if (m_part == 0) {
        alpha_s[m_row] = alpha;
        l_s[m_row] = l_run;
      }
    }
    __syncthreads();  // P and the rescale factors are in shared memory

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = alpha_s[o_row + 4 * i];
#pragma unroll
      for (int c = 0; c < 4 * kRuns; ++c) o[i][c] *= a;
    }
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float p[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 t = lds4(ps + (o_row + 4 * i) * kPStride + j);
        p[i][0] = t.x;
        p[i][1] = t.y;
        p[i][2] = t.z;
        p[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vr[kRuns];
#pragma unroll
        for (int r = 0; r < kRuns; ++r)
          vr[r] = lds4(vs + (j + jj) * kVStride + o_col + 32 * r);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pj = p[i][jj];
#pragma unroll
          for (int r = 0; r < kRuns; ++r) {
            o[i][4 * r] = fmaf(pj, vr[r].x, o[i][4 * r]);
            o[i][4 * r + 1] = fmaf(pj, vr[r].y, o[i][4 * r + 1]);
            o[i][4 * r + 2] = fmaf(pj, vr[r].z, o[i][4 * r + 2]);
            o[i][4 * r + 3] = fmaf(pj, vr[r].w, o[i][4 * r + 3]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with P and V
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + o_row + 4 * i;
    if (row >= s) continue;
    const float denom = fmaxf(l_s[o_row + 4 * i], 1e-30f);
    float* dst = out + (static_cast<size_t>(bh) * s + row) * kHd + o_col;
#pragma unroll
    for (int r = 0; r < kRuns; ++r)
      *reinterpret_cast<float4*>(dst + 32 * r) =
          make_float4(o[i][4 * r] / denom, o[i][4 * r + 1] / denom,
                      o[i][4 * r + 2] / denom, o[i][4 * r + 3] / denom);
  }
}

template <int kHd>
int launch(const float* q, const float* k, const float* v, float* out,
           int bh, int group, int s, int causal, int window, float scale,
           float softcap, cudaStream_t stream) {
  constexpr int kSmemBytes = Layout<kHd>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<kHd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kRows - 1) / kRows, bh);
  flash_kernel<kHd><<<grid, kThreads, kSmemBytes, stream>>>(
      q, k, v, out, group, s, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out (bh, s, hd); k, v (bh / group, s, hd); f32, contiguous and 16-byte
// aligned; hd 128 or 256. window <= 0: none; softcap <= 0: none. Returns a
// cudaError_t (cudaErrorInvalidValue for a shape the kernel is not built for).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int bh, int group,
                                   int s, int causal, int window, int hd,
                                   float scale, float softcap, void* stream) {
  if (group < 1 || bh < 1 || bh % group || bh > 65535 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128>(qf, kf, vf, of, bh, group, s, causal, window, scale,
                       softcap, st);
  if (hd == 256)
    return launch<256>(qf, kf, vf, of, bh, group, s, causal, window, scale,
                       softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
