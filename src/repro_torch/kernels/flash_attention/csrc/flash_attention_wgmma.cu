// Flash attention on Hopper's tensor cores: GQA, causal masking, a sliding
// window and a tanh logit softcap, head_dim 128 or 256, bf16 in and out:
//   out[bh, i] = softmax_j(mask(cap(q[bh, i] . k[bh / group, j] / sqrt(hd))))
//                . v[bh / group, j]
// with the mask j <= i (causal) and i - j < window, f32 accumulation, and
// the products on the bf16 tensor cores. q, k, v, out are (rows, S, hd),
// contiguous; Skv == Sq. The kernel is a template on hd with one instance
// for each head_dim on the path: 256 (gemma2) and 128 (granite, starcoder2,
// yi, deepseek-moe, qwen3-moe, pixtral). The f32 path is the register-tiled
// CUDA-core kernel in flash_attention.cu.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py, which walks (128, hd) query
// blocks over a sequential grid axis of (128, hd) key blocks on the MXU and
// keeps the running max, denominator and accumulator in VMEM scratch.
//
// Bound on the H100: operations. 4 * hd flops per unmasked (query, key)
// pair on the bf16 tensor cores (989 TFLOP/s); at gemma2's prefill shape
// that is about 3.5e11 flops, 0.35 ms, against 0.07 ms for its 226 MB of q,
// k, v and out; qwen3-moe's (hd 128, 32 query heads) does the same work.
//
// Design: one block of 384 threads per 128 query rows of one (batch, head),
// in three warpgroups.
// - Warpgroup 0 is the producer: one thread issues TMA loads (128-byte
//   swizzle, 64 columns per box, so a row is hd / 64 boxes) of the Q
//   block once and of 64-key K and V tiles into a 2-stage ring; each stage
//   has "full" barriers for K and for V and an "empty" barrier. TMA fills
//   rows past S with zeros, so ragged tails read no garbage. setmaxnreg
//   gives its registers to the consumers.
// - Warpgroups 1 and 2 each own 64 query rows. Per tile: S = Q K^T with
//   hd / 16 wgmma m64n64k16 (A = Q and B = K from shared memory, K-major);
//   scale, then softcap (tanh.approx), then mask, in log2 units (log2(e)
//   folded into the scale) and only on tiles that cross the diagonal, the
//   window's edge or S; the online softmax (ex2.approx) over the 4 threads
//   that share a row of the accumulator; P rounded to bf16 in registers,
//   which is the A operand layout of wgmma as it stands; O += P V with 4
//   wgmma m64n{hd}k16 (B = V from shared memory, MN-major), so O takes hd / 2
//   accumulator registers a consumer thread (128 at hd 256, 64 at hd 128).
//   A warpgroup skips the products of a tile wholly masked for its rows but
//   still releases it.
// - The block's key range skips tiles wholly past the diagonal or before the
//   window; blocks start from the last (longest) row block.
// - Epilogue: O / max(l, 1e-30) in bf16 goes through the warpgroup's own
//   rows of the Q buffer (swizzled, so without bank conflicts) and out in
//   16-byte stores of whole rows.
// At hd 128 the ring's stages are half as large (shared memory 97 KB, not
// 193 KB); the design is otherwise the same.
// Masked logits are -1e30, never -inf, as in the TPU kernel: a tile that is
// wholly masked for a row before its first real key gives p = 1 for its
// keys, and that is wiped by alpha = exp2(-1e30 - m) = 0 when the real keys
// arrive.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBr = 128;       // query rows per block, 64 per consumer
constexpr int kBc = 64;        // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kSpan = 128;     // bytes of one swizzled row: 64 bf16 columns
constexpr int kQChunk = kBr * kSpan;   // one 64-column box of the Q block
constexpr int kKVChunk = kBc * kSpan;  // one 64-column box of a K/V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// hd / 64 boxes of (128 rows, 64 cols) for Q, of (64 keys, 64 cols) for a
// K or V tile
template <int kHd>
struct alignas(1024) Smem {
  static constexpr int kQBytes = kBr * kHd * 2;
  static constexpr int kTileBytes = kBc * kHd * 2;
  unsigned char q[kQBytes];
  unsigned char k[kStages][kTileBytes];
  unsigned char v[kStages][kTileBytes];
  uint64_t full_q, full_k[kStages], full_v[kStages], empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Arrives once and expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-d tensor map (columns, rows, heads) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand; byte
// offsets lbo (leading) and sbo (stride) as the PTX ISA defines them.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (m64 x n64, f32) (+)= A (64 x 16, shared) . B (16 x 64, shared),
// both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t a,
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (m64 x n256, f32) += A (64 x 16, bf16 registers) . B (16 x 256, shared),
// B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// D (m64 x n128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, shared),
// B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// O (64 x hd) += P (64 x 16 keys) . V (16 keys x hd): one wgmma of width hd.
template <int kHd>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* p,
                                         uint64_t v) {
  if constexpr (kHd == 256)
    wgmma_m64n256k16_rs(o, p, v);
  else
    wgmma_m64n128k16_rs(o, p, v);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// c1, c2: logit = c2 * tanh(c1 * q.k) with a softcap (c2 > 0), c1 * q.k
// without, both in log2 units.
template <int kHd>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ out, int group, int s,
                   int causal, int window, float c1, float c2) {
  extern __shared__ unsigned char smem_raw[];
  static_assert(kHd == 128 || kHd == 256, "wgmma_pv has n128 and n256");
  using S = Smem<kHd>;
  S& sm = *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int bh = blockIdx.x;
  // the last row blocks carry the most keys under causal masking: start them
  // first
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBr;
  const int lo = window > 0 ? max(0, r0 - window + 1) : 0;
  const int hi = causal ? min(r0 + kBr, s) : s;  // keys [lo, hi) reach it
  const int tile_lo = lo / kBc;
  const int n_tiles = (hi + kBc - 1) / kBc - tile_lo;
  const uint32_t bar_q = smem_u32(&sm.full_q);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(smem_u32(&sm.full_k[st]), 1);
      mbar_init(smem_u32(&sm.full_v[st]), 1);
      mbar_init(smem_u32(&sm.empty[st]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer -----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      const int kv = bh / group;
      mbar_expect_tx(bar_q, S::kQBytes);
      for (int c = 0; c < kHd / 64; ++c)
        tma_load(smem_u32(sm.q + c * kQChunk), &q_map, bar_q, 64 * c, r0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages)  // the consumers are done with this stage's last use
          mbar_wait(smem_u32(&sm.empty[st]), (i / kStages - 1) & 1);
        const int t0 = (tile_lo + i) * kBc;
        const uint32_t fk = smem_u32(&sm.full_k[st]);
        const uint32_t fv = smem_u32(&sm.full_v[st]);
        mbar_expect_tx(fk, S::kTileBytes);
        for (int c = 0; c < kHd / 64; ++c)
          tma_load(smem_u32(sm.k[st] + c * kKVChunk), &k_map, fk, 64 * c, t0,
                   kv);
        mbar_expect_tx(fv, S::kTileBytes);
        for (int c = 0; c < kHd / 64; ++c)
          tma_load(smem_u32(sm.v[st] + c * kKVChunk), &v_map, fv, 64 * c, t0,
                   kv);
      }
    }
  } else {
    // consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int wr0 = r0 + 64 * wg;  // the warpgroup's first row
    // accumulator layout: this thread holds rows row0 and row0 + 8, and in
    // each 8-column group n the columns 8 n + col0 and 8 n + col0 + 1
    const int row0 = wr0 + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_wg = smem_u32(sm.q) + 64 * wg * kSpan;

    float o[kHd / 2];
#pragma unroll
    for (int i = 0; i < kHd / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(bar_q, 0);

#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int t0 = (tile_lo + i) * kBc;
      const bool skip = (causal && t0 > wr0 + 63) ||
                        (window > 0 && wr0 - (t0 + kBc - 1) >= window);
      mbar_wait(smem_u32(&sm.full_k[st]), parity);
      if (!skip) {
        // S = Q K^T over hd / 16 k-steps of 16 dims; within a 64-column box a
        // k-step advances the start address by 32 bytes
        float sc[32];  // the first k-step overwrites it (scale-d = 0)
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        const uint32_t k_st = smem_u32(sm.k[st]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk)
          wgmma_m64n64k16_ss(
              sc,
              smem_desc(q_wg + (kk / 4) * kQChunk + (kk % 4) * 32, 16, 1024),
              smem_desc(k_st + (kk / 4) * kKVChunk + (kk % 4) * 32, 16, 1024),
              kk > 0);
        wgmma_commit_and_wait();
        fence_regs<32>(sc);

        // scale, softcap, mask (log2 units)
#pragma unroll
        for (int j = 0; j < 32; ++j)
          sc[j] = c2 > 0.f ? c2 * tanh_approx(c1 * sc[j]) : c1 * sc[j];
        if (t0 + kBc > s || (causal && t0 + kBc - 1 > wr0) ||
            (window > 0 && wr0 + 63 - t0 >= window)) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int row = row0 + 8 * ((j >> 1) & 1);
            const int key = t0 + 8 * (j / 4) + col0 + (j & 1);
            const bool ok = key < s && (!causal || key <= row) &&
                            (window <= 0 || row - key < window);
            if (!ok) sc[j] = kNegInf;
          }
        }

        // online softmax: each row is spread over 4 neighbouring lanes
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 32; ++j)
          mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2_approx(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
        // P in bf16: accumulator elements 8 kk + 2 t, + 1 are A's register t
        // of k-step kk
        uint32_t p[16];
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int r = (j >> 1) & 1;
          const float p0 = exp2_approx(sc[j] - m[r]);
          const float p1 = exp2_approx(sc[j + 1] - m[r]);
          l[r] += p0 + p1;
          p[j / 2] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int j = 0; j < kHd / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

        // O += P V over 4 k-steps of 16 keys: V is MN-major, its 64-column
        // boxes lbo = 8 KB apart, groups of 8 keys sbo = 1 KB apart
        mbar_wait(smem_u32(&sm.full_v[st]), parity);
        const uint32_t v_st = smem_u32(sm.v[st]);
        fence_regs<kHd / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBc / 16; ++kk)
          wgmma_pv<kHd>(o, p + 4 * kk,
                        smem_desc(v_st + kk * 16 * kSpan, kKVChunk, 1024));
        wgmma_commit_and_wait();
        fence_regs<kHd / 2>(o);
      } else {
        mbar_wait(smem_u32(&sm.full_v[st]), parity);
      }
      mbar_arrive(smem_u32(&sm.empty[st]));
    }

    // epilogue: normalise, stage the warpgroup's 64 rows in bf16 in its own
    // rows of the Q buffer (same swizzle), then 16-byte stores of whole rows
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    unsigned char* stage = sm.q + 64 * wg * kSpan;
    warpgroup_sync(1 + wg);  // every warp's last read of these Q rows is done
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * warp + lane / 4 + 8 * h;
        *reinterpret_cast<uint32_t*>(
            stage + (n / 8) * kQChunk + rl * kSpan +
            (((n % 8) ^ (rl % 8)) * 16) + col0 * 2) =
            pack_bf16(o[4 * n + 2 * h] * inv[h],
                      o[4 * n + 2 * h + 1] * inv[h]);
      }
    }
    warpgroup_sync(1 + wg);
#pragma unroll 4
    for (int it = 0; it < 64 * kHd * 2 / 16 / 128; ++it) {
      constexpr int kRowChunks = kHd * 2 / 16;  // 16-byte columns of a row
      const int idx = it * 128 + tid;
      const int rl = idx / kRowChunks, c16 = idx % kRowChunks;
      const int row = wr0 + rl;
      if (row < s)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(bh) * s + row) *
                                            kHd + 8 * c16) =
            *reinterpret_cast<const uint4*>(
                stage + (c16 / 8) * kQChunk + rl * kSpan +
                (((c16 % 8) ^ (rl % 8)) * 16));
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library need not link libcuda.
int encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// (heads, s, hd) bf16 as a 3-d map of boxes (64 columns, box_rows rows, 1),
// 128-byte swizzle; rows past s read as zeros.
template <int kHd>
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, int heads,
                int s, int box_rows) {
  const cuuint64_t dims[3] = {kHd, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {kHd * 2,
                                 static_cast<cuuint64_t>(s) * kHd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The launch for one head_dim: tensor maps, shared memory, grid.
template <int kHd>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int group, int s, int causal, int window, float scale,
           float softcap, cudaStream_t stream) {
  EncodeTiled fn;
  const int err = encode_fn(&fn);
  if (err != 0) return err;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const CUresult r = encode<kHd>(fn, &maps[i], bases[i],
                                   i ? bh / group : bh, s, i ? kBc : kBr);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  const int smem = static_cast<int>(sizeof(Smem<kHd>)) + 1024;  // + align
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<kHd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool capped = softcap > 0.f;
  flash_wgmma_kernel<kHd><<<dim3(bh, (s + kBr - 1) / kBr), kThreads, smem,
                            stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), group, s,
      causal, window, capped ? scale / softcap : scale * kLog2e,
      capped ? softcap * kLog2e : 0.f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out (bh, s, hd); k, v (bh / group, s, hd); bf16, contiguous and 16-byte
// aligned; hd 128 or 256; s <= 65535 * 128. window <= 0: none; softcap <= 0:
// none. Returns a cudaError_t (cudaErrorInvalidValue for a shape the kernel
// is not built for), or the CUresult of a failed tensor-map encode.
extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k,
                                          const void* v, void* out, int bh,
                                          int group, int s, int causal,
                                          int window, int hd, float scale,
                                          float softcap, void* stream) {
  if (group < 1 || bh < 1 || bh % group || s < 1 ||
      (s + kBr - 1) / kBr > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128>(q, k, v, out, bh, group, s, causal, window, scale,
                       softcap, st);
  if (hd == 256)
    return launch<256>(q, k, v, out, bh, group, s, causal, window, scale,
                       softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
