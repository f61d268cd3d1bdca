// Segment-sum (the processor's receiver scatter-add) over a CSR of
// receiver-sorted edges: out[n] = sum over j in [row_ptr[n], row_ptr[n+1])
// of msg[perm[j]], in f32, for msg (E, D) f32 and out (N, D) f32.
//
// The same kernel is also the transpose of a row gather, for training: the
// gradient of h[idx] with respect to h is the segment-sum of the gathered
// rows' gradient over a CSR sorted by idx (a sender CSR for h[senders], the
// receiver CSR for h[receivers]). Autograd hands that gradient over as a
// column slice of the gradient of torch.cat, so msg rows are `stride` float4s
// apart and are read in place; the aggregation passes stride == cols.
//
// Replaces the TPU kernel `_agg_kernel` / `segment_agg_call` in
// src/repro/kernels/segment_agg/kernel.py. That kernel computes the sum as a
// one-hot MXU matmul over edges packed into a fixed per-node-block budget,
// with a scatter fallback on overflow, because the TPU has no fast scatter.
// Hopper scatters and gathers rows well, so none of that carries over.
//
// Bound on the H100: bytes. Every valid message row is read once
// (E_valid * D * 4 B) and every output row written once (N * D * 4 B), plus
// the index arrays; there is one add per 4 bytes read.
//
// Design: a group of blockDim.x threads owns one node (blockDim.y nodes per
// block) and walks its CSR run, reading each message row as float4s with
// consecutive threads on consecutive columns, and summing in registers in
// edge order. No atomics and no budget: the result does not depend on run
// order, every node row is written (zeros for an empty run), and the sum
// order equals the plain version's. Masked padding edges are left out of the
// CSR by the caller, so no node carries a long serial run. A strided msg
// costs no more bytes: only the slice's D columns of each row are read.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

__global__ void segment_sum_kernel(const float4* __restrict__ msg,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ row_ptr,
                                   float4* __restrict__ out, int n_nodes,
                                   int cols, int stride) {
  const int node = blockIdx.x * blockDim.y + threadIdx.y;
  if (node >= n_nodes) return;
  const int beg = row_ptr[node];
  const int end = row_ptr[node + 1];
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = beg; j < end; ++j) {
      add4(acc, msg[static_cast<size_t>(perm[j]) * stride + c]);
    }
    out[static_cast<size_t>(node) * cols + c] = acc;
  }
}

// ---------------------------------------------------------------------------
// The backward of segment-sum, for training: the transpose of the sum above.
// grad_msg[perm[j]] = grad_out[n] for every j in [row_ptr[n], row_ptr[n+1]),
// and grad_msg[perm[j]] = 0 for every j in [row_ptr[n_nodes], n_edges), the
// masked edges that no run covers.
//
// Port-only: the JAX package has no backward kernel. Its trainer
// differentiates `jax.ops.segment_sum` (src/repro/models/meshgraphnet.py:87)
// and XLA emits the transpose, a row gather grad_out[recv] (masked edges get
// grad_out[0], zeroed upstream by the edge mask).
//
// Bound on the H100: bytes. Every row of grad_msg is written once
// (E * D * 4 B) and every row of grad_out read once (N * D * 4 B), plus the
// index arrays; there is no arithmetic.
//
// Design: as the forward, a group of blockDim.x threads owns one node
// (blockDim.y nodes per block). It reads its grad_out row once, float4s on
// consecutive columns, and stores it to the row of each edge of its run. The
// blocks past the node blocks zero the masked rows in a grid-stride loop.
// perm is a permutation of the edges, so every row of grad_msg is written
// exactly once: no atomics, no memset, and the result is bit-equal to the
// plain version, since a copy does not round. grad_out may be a column slice
// of a wider tensor (the gradient of torch.cat): its rows are `stride` float4s
// apart.
__global__ void segment_sum_backward_kernel(
    const float4* __restrict__ grad_out, const int* __restrict__ perm,
    const int* __restrict__ row_ptr, float4* __restrict__ grad_msg,
    int n_nodes, int n_edges, int cols, int stride, int node_blocks) {
  if (static_cast<int>(blockIdx.x) < node_blocks) {
    const int node = blockIdx.x * blockDim.y + threadIdx.y;
    if (node >= n_nodes) return;
    const int beg = row_ptr[node];
    const int end = row_ptr[node + 1];
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const float4 g = grad_out[static_cast<size_t>(node) * stride + c];
      for (int j = beg; j < end; ++j) {
        grad_msg[static_cast<size_t>(perm[j]) * cols + c] = g;
      }
    }
    return;
  }
  const int groups = (gridDim.x - node_blocks) * blockDim.y;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = row_ptr[n_nodes] + (blockIdx.x - node_blocks) * blockDim.y +
               threadIdx.y;
       j < n_edges; j += groups) {
    float4* row = grad_msg + static_cast<size_t>(perm[j]) * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) row[c] = zero;
  }
}

}  // namespace

// msg (E, d) f32 with rows `stride` floats apart, perm (>= row_ptr[n_nodes],)
// i32, row_ptr (n_nodes + 1,) i32, out (n_nodes, d) f32 contiguous;
// d % 4 == 0, stride % 4 == 0, stride >= d, msg and out 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int segment_sum_f32(const void* msg, const void* perm,
                               const void* row_ptr, void* out, int n_nodes,
                               int d, int stride, int threads_x,
                               int threads_y, void* stream) {
  if (d % 4 != 0 || stride % 4 != 0 || stride < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(threads_x, threads_y);
  const dim3 grid((n_nodes + threads_y - 1) / threads_y);
  segment_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(msg), static_cast<const int*>(perm),
      static_cast<const int*>(row_ptr), static_cast<float4*>(out), n_nodes,
      d / 4, stride / 4);
  return static_cast<int>(cudaGetLastError());
}

// grad_out (n_nodes, d) f32 with rows `stride` floats apart, perm (n_edges,)
// i32 (a permutation of the edges), row_ptr (n_nodes + 1,) i32, grad_msg
// (n_edges, d) f32 contiguous; d % 4 == 0, stride % 4 == 0, grad_out and
// grad_msg 16-byte aligned. tail_blocks blocks zero the masked rows. Returns
// cudaGetLastError().
extern "C" int segment_sum_backward_f32(const void* grad_out, const void* perm,
                                        const void* row_ptr, void* grad_msg,
                                        int n_nodes, int n_edges, int d,
                                        int stride, int threads_x,
                                        int threads_y, int tail_blocks,
                                        void* stream) {
  if (d % 4 != 0 || stride % 4 != 0 || tail_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(threads_x, threads_y);
  const int node_blocks = (n_nodes + threads_y - 1) / threads_y;
  const dim3 grid(node_blocks + tail_blocks);
  segment_sum_backward_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(grad_out), static_cast<const int*>(perm),
      static_cast<const int*>(row_ptr), static_cast<float4*>(grad_msg),
      n_nodes, n_edges, d / 4, stride / 4, node_blocks);
  return static_cast<int>(cudaGetLastError());
}
