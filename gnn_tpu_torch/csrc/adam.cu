// Adam's update of a parameter group's float32 leaves in one launch:
//   g <- g + wd * p                                   [coupled L2 only]
//   m <- b1 * m + (1 - b1) * g ;  v <- b2 * v + (1 - b2) * g^2
//   p <- p + (-lr * m / bc1) / (sqrt(v / bc2) + eps)  [- lr * wd * p, decoupled]
// term by term as optim/adam.py writes it with foreach ops, each product,
// sum and quotient rounded once to float32 in the same order (__fmul_rn and
// friends: no fused multiply-add, IEEE division and square root), so the
// kernel takes the steps that the foreach ops take.
//
// Replaces no Pallas kernel: the JAX package's adam is optax-style jnp
// arithmetic that XLA fuses. The port ran about fifteen foreach launches a
// step, each a pass over every leaf, and their host issue; on the
// benchmark's GAT (8 leaves, 11,064 values) that host issue was 0.6 ms of a
// 5.5 ms step on an H100's host. The values are few: the launch is the cost.
//
// Design: the leaves' pointers and sizes ride in the kernel's parameters
// (up to kAdamLeaves a launch; the C entry loops over more), one thread a
// value, the leaf found by a linear scan of the leaves' offsets.

#include <cstdint>

#include <cuda_runtime.h>

namespace gnn {

constexpr int kAdamLeaves = 32;
constexpr int kAdamBlock = 256;

struct AdamLeaves {
  float* p[kAdamLeaves];
  const float* g[kAdamLeaves];
  float* m[kAdamLeaves];
  float* v[kAdamLeaves];
  int64_t start[kAdamLeaves + 1];  // offsets of the leaves in the launch's values
  int n;
};

struct AdamScalars {
  float b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps, neg_lr, wd, lr_wd;
  int decoupled;
};

__global__ void __launch_bounds__(kAdamBlock) adam_kernel(const AdamLeaves leaves, const AdamScalars c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kAdamBlock + threadIdx.x;
  if (i >= leaves.start[leaves.n]) return;
  int l = 0;
  while (i >= leaves.start[l + 1]) ++l;
  const int64_t j = i - leaves.start[l];
  const float p = leaves.p[l][j];
  float g = leaves.g[l][j];
  if (!c.decoupled && c.wd != 0.f) g = __fadd_rn(g, __fmul_rn(p, c.wd));
  const float m = __fadd_rn(__fmul_rn(leaves.m[l][j], c.b1), __fmul_rn(g, c.one_minus_b1));
  const float v = __fadd_rn(__fmul_rn(leaves.v[l][j], c.b2), __fmul_rn(__fmul_rn(g, g), c.one_minus_b2));
  leaves.m[l][j] = m;
  leaves.v[l][j] = v;
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)), c.eps);
  float upd = __fdiv_rn(__fmul_rn(__fdiv_rn(m, c.bc1), c.neg_lr), den);
  if (c.decoupled && c.wd != 0.f) upd = __fsub_rn(upd, __fmul_rn(p, c.lr_wd));
  leaves.p[l][j] = __fadd_rn(p, upd);
}

}  // namespace gnn

extern "C" {

// Enqueues the update of n_leaves float32 leaves on `stream`, one launch per
// kAdamLeaves of them; returns cudaGetLastError(). p, g, m, v: arrays of
// n_leaves device pointers (parameter, gradient, first and second moment,
// each of sizes[i] contiguous values). scalars: b1, 1 - b1, b2, 1 - b2, the
// bias corrections bc1 and bc2, eps, -lr, wd and lr * wd, each rounded to
// float32 as a foreach op rounds its scalar; decoupled: AdamW's decay.
int gnn_adam_f32(void* const* p, void* const* g, void* const* m, void* const* v,
                 const int64_t* sizes, int n_leaves, const float* scalars, int decoupled,
                 void* stream) {
  if (n_leaves < 0) return static_cast<int>(cudaErrorInvalidValue);
  gnn::AdamScalars c{scalars[0], scalars[1], scalars[2], scalars[3], scalars[4],
                     scalars[5], scalars[6], scalars[7], scalars[8], scalars[9], decoupled};
  for (int first = 0; first < n_leaves; first += gnn::kAdamLeaves) {
    gnn::AdamLeaves leaves{};
    leaves.n = n_leaves - first < gnn::kAdamLeaves ? n_leaves - first : gnn::kAdamLeaves;
    leaves.start[0] = 0;
    for (int l = 0; l < leaves.n; ++l) {
      if (sizes[first + l] < 0) return static_cast<int>(cudaErrorInvalidValue);
      leaves.p[l] = static_cast<float*>(p[first + l]);
      leaves.g[l] = static_cast<const float*>(g[first + l]);
      leaves.m[l] = static_cast<float*>(m[first + l]);
      leaves.v[l] = static_cast<float*>(v[first + l]);
      leaves.start[l + 1] = leaves.start[l] + sizes[first + l];
    }
    const int64_t n_values = leaves.start[leaves.n];
    if (n_values == 0) continue;
    const dim3 grid(static_cast<unsigned>((n_values + gnn::kAdamBlock - 1) / gnn::kAdamBlock));
    gnn::adam_kernel<<<grid, gnn::kAdamBlock, 0, static_cast<cudaStream_t>(stream)>>>(leaves, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
