// K3: multi-head edge-weighted CSR SpMM,
//   out[r, h, :] = sum_k w[widx(k), h] * x[col[k], h, :]
// over k in [row_ptr[r], row_ptr[r + 1]); x is [N, H, F], w is [E, H], and
// widx(k) = w_index[k], or k where w_index is null.
//
// Replaces GAT's numerator in gnn_tpu/mp/gat.py (GATConv.__call__ :193-202):
// there the per-edge messages ex_num[e, h] * h[src_e, h, :] are written out
// as an [E, H * F] array and reduced by the Pallas segment sum
// (gnn_tpu/ops/pallas/segment.py::segment_sum_sorted through
// ops/segment.py::segment_sum_edges). Here the gather, the per-head scale and
// the per-row reduction are one kernel, so that array never exists. The same
// kernel runs the backward dh = A_w^T g over the transpose CSR
// (t_row_ptr, dst[t_perm]) with w_index = t_perm, so the weights are read in
// place and no permuted copy w[t_perm] is written.
//
// Design: csr_reduce.cuh's GatherHeads instance -- K1 over rows of H * F
// features, where the weight of edge k for a lane at feature f is
// w[widx(k) * H + f / F]. Merge-path tiles of a fixed number of row ends and
// edges per warp (a 21,305-edge hub spans 84 warps where the kernel this
// replaces gave it to one), col and w_index staged through shared memory with
// cp.async, lane groups sized to H * F (32 lanes an edge at (8, 32), 16 at
// (1, 40), so two edges a warp step), a fixup launch for rows cut by a tile
// boundary; float32 sums, no atomics, deterministic. With H = 1 it sums the
// same products as K1 in the same order. The weights stay in global memory:
// the H weights of an edge are one 32-byte sector at H = 8, read once by the
// lanes of a warp beside the feature loads; staging 2,048 x H of them a CTA
// takes 64 KB of shared memory and leaves an SM two CTAs instead of eight,
// which on an H100 (700 W) measured 0.95 against 0.81 ms at (8, 32) in
// float32 and 0.70 against 0.53 ms in bfloat16 (tools/ab_kernels.py).
//
// What bounds it on an H100: bytes. Each input and output once (x, out, w,
// col, row_ptr) is 437 MB at ogbn-arxiv scale and (H, F) = (8, 32) in float32,
// 0.130 ms at 3.35 TB/s; with no reuse of a gathered row (x is 173 MB, over
// the 50 MB L2) the E * H * F gathered bytes make it 2.80 GB, 0.836 ms. At
// (1, 40): 75 MB, 0.022 ms, and 0.133 ms with no reuse. 2 flops per 4-8
// bytes moved: no tensor cores.

#include "csr_reduce.cuh"

extern "C" {

// Each entry enqueues the reduction and its fixup on `stream` and returns
// cudaGetLastError(). w_index may be null. part / part_row: scratch of
// gnn_csr_reduce_tiles tiles at width H * F.
int gnn_gat_spmm_f32(const void* row_ptr, const void* col, const void* w,
                     const void* w_index, const void* x, void* out, void* part,
                     void* part_row, int n_rows, int n_edges, int H, int F, int vec,
                     void* stream) {
  return gnn::launch_csr_reduce<float, gnn::GatherHeads>(
      row_ptr, col, w, w_index, x, out, part, part_row, n_rows, n_edges, H * F, H, vec, stream);
}

int gnn_gat_spmm_bf16(const void* row_ptr, const void* col, const void* w,
                      const void* w_index, const void* x, void* out, void* part,
                      void* part_row, int n_rows, int n_edges, int H, int F, int vec,
                      void* stream) {
  return gnn::launch_csr_reduce<__nv_bfloat16, gnn::GatherHeads>(
      row_ptr, col, w, w_index, x, out, part, part_row, n_rows, n_edges, H * F, H, vec, stream);
}

}  // extern "C"
