// K2 backward: the gradient of the whole masked autoregressive transform
// stack (made_rqs_forward.cu) with respect to its input and, through the
// layers' deltas, its masked weights and biases; templated on the head as
// the forward is (heads.cuh: the spline's VJP or the affine map's).
//
// Replaces the backward of the Pallas MADE kernel of
// pocomc_tpu/ops/pallas_kernels.py (`make_made_apply`'s custom VJP, deleted
// in commit 246a898), which re-ran the pass as XLA code, and the XLA
// gradient that jax.value_and_grad takes of the training loss
// (pocomc_tpu/models/flow.py Flow._loss_fn, parallel/fused.py train step).
//
// What bounds it on the H100: the products g * W^T back through the four
// layers and the output layer's product again, 2 * T * (d*h + 2*h*h +
// 2*h*NP*d) flops a row dense (the weight-gradient products A^T * g are
// torch.bmm's, outside the kernel). At nsf6, d=10 (h=32) and the training
// batch of 1024 rows it is latency: a chain of T transforms, each a spline
// backward and four transposed products, with block barriers between; at
// d=50 (h=256) the products (438,272 multiply-adds a row and transform).
//
// Design: K5's backward (stack_backward.cuh, coupling_tile.cuh) on the
// MADE network, every dimension both conditioning and transformed (the
// masked weights taken as dense): a producer warp streams whole slabs of
// the output layer and of every W^T with bulk copies into an S-stage ring
// under mbarriers; 8 consumer warps hold RM x RN register tiles of up to
// 64 rows a block and read the layer inputs the forward saved k-major;
// the output layer runs in groups of whole dimensions as wide as an output
// pass. The weights change at every optimizer step, and a MADE output
// row (NP*d floats) sits off a 16-byte boundary, so a first kernel of the
// same launch (pack_kernel) lays them out as coupling_tile.cuh Packed
// describes, into a scratch tensor the wrapper allocates: no host repack
// is added to a training step. The deltas of the four layers go to
// scratch (T, n, .), rows < n only; the wrapper takes the weight gradients
// from them and the saved activations with batched products and row sums
// over T, so no float atomics sit anywhere on the gradient path and every
// run gives the same bits. fp32 FMAs only.
#include <cuda_runtime.h>

#include "stack_backward.cuh"

namespace {

using namespace pocomc;

// The packed copies of one MADE stack's masked weights w[l] (T, K_l, N_l):
// w3p (T, NG, subs, h, ldo), each output group's G*np columns in subs
// blocks of ldo (one, but for the spline of run-time bins: coupling_tile.cuh
// Plan::subs), zero-padded; wtp (T, rows, PW), each transform's W0^T (ceil(d/PW) passes of h
// rows), W1^T, W2^T (ceil(h/PW) passes of h rows each) and W3^T (ceil(h/PW)
// passes of d*np rows), a pass's PW columns zero-padded: coupling_tile.cuh
// Packed with wide = d.
struct PackShape {
  int d, h, T, np, G, ldo, PW;
  __host__ __device__ size_t n3() const { return (size_t)d * np; }
  __host__ __device__ size_t ng() const { return (d + G - 1) / G; }
  __host__ __device__ size_t subs() const { return ((size_t)G * np + ldo - 1) / ldo; }
  __host__ __device__ size_t w3_per_t() const { return ng() * subs() * h * ldo; }
  __host__ __device__ size_t p0() const { return (d + PW - 1) / PW; }
  __host__ __device__ size_t ph() const { return (h + PW - 1) / PW; }
  __host__ __device__ size_t wt_rows() const { return p0() * h + 2 * ph() * h + ph() * n3(); }
  __host__ __device__ size_t w3_floats() const { return (size_t)T * w3_per_t(); }
  __host__ __device__ size_t floats() const { return w3_floats() + (size_t)T * wt_rows() * PW; }
};

// one thread a packed float: the source element of w, or 0 in the padding
__global__ void __launch_bounds__(256)
    pack_kernel(const float* __restrict__ w0, const float* __restrict__ w1,
                const float* __restrict__ w2, const float* __restrict__ w3, float* __restrict__ pk,
                PackShape s) {
  const size_t n3 = s.n3(), h = s.h, d = s.d, PW = s.PW;
  const size_t total = s.floats(), w3_total = s.w3_floats();
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.0f;
    if (i < w3_total) {
      const size_t t = i / s.w3_per_t(), r = i - t * s.w3_per_t();
      const size_t b = r / (h * s.ldo), k = (r / s.ldo) % h;
      const size_t g = b / s.subs(), c = (b - g * s.subs()) * s.ldo + r % s.ldo;
      const size_t col = g * s.G * s.np + c;
      if (c < (size_t)s.G * s.np && col < n3) v = w3[(t * h + k) * n3 + col];
    } else {
      const size_t j = i - w3_total, per_t = s.wt_rows() * PW;
      const size_t t = j / per_t, row = (j - t * per_t) / PW, kk = j % PW;
      const size_t s0 = s.p0() * h, s1 = s0 + s.ph() * h, s2 = s1 + s.ph() * h;
      if (row < s0) {  // W0^T: pass c, contraction row jj of h, output row k of d
        const size_t c = row / h, jj = row % h, k = c * PW + kk;
        if (k < d) v = w0[(t * d + k) * h + jj];
      } else if (row < s2) {  // W1^T, W2^T
        const float* w = row < s1 ? w1 : w2;
        const size_t rr = row - (row < s1 ? s0 : s1), c = rr / h, jj = rr % h, k = c * PW + kk;
        if (k < h) v = w[(t * h + k) * h + jj];
      } else {  // W3^T: contraction row jj of d*np, output row k of h
        const size_t rr = row - s2, c = rr / n3, jj = rr % n3, k = c * PW + kk;
        if (k < h) v = w3[(t * h + k) * n3 + jj];
      }
    }
    pk[i] = v;
  }
}

}  // namespace

// shared-memory floats of one block (stack_backward.cuh smem_floats)
extern "C" int made_rqs_backward_smem_floats(int RL, int BM, int RNH, int RNO, int G, int BK,
                                             int S, int d, int h, int np) {
  return pocomc::stack::smem_floats(RL, BM, RNH, RNO, G, BK, S, d, h, np);
}

// floats of the packed weights the entry point writes into `pack`
extern "C" long long made_rqs_backward_pack_floats(int d, int h, int T, int np, int G, int ldo,
                                                   int PW) {
  return (long long)PackShape{d, h, T, np, G, ldo, PW}.floats();
}

// Plain C entry point, loaded with ctypes. a0 (T, n, d) and a1..a3
// (T, n, h) are the inputs of every layer's product as the forward kernel
// saved them; gz (n, d) and gladj (n,) are dL/dz and dL/dladj; gy (n, d)
// receives dL/dy and g0..g3 (T, n, h|h|h|d*np) the deltas of the four
// layers. Weights (masked, (T, K, N) and (T, N), 16-byte aligned) and np
// as for made_rqs_forward_launch. pack is scratch of
// made_rqs_backward_pack_floats floats (16-byte aligned), which a first
// kernel fills with the packed weights. The tile (RL, BM, RNH, RNO, G,
// BK, S) as for coupling_backward_launch (coupling_tile.cuh), G whole
// dimensions of d an output group. Launches both kernels on `stream` and
// returns cudaGetLastError().
extern "C" int made_rqs_backward_launch(const float* a0, const float* a1, const float* a2,
                                        const float* a3, const float* gz, const float* gladj,
                                        float* gy, int n, int d, int h, int T, const float* w0,
                                        const float* w1, const float* w2, const float* w3,
                                        const float* b3, float* g0, float* g1, float* g2,
                                        float* g3, float* pack, int np, int RL, int BM, int RNH,
                                        int RNO, int G, int BK, int S, int device,
                                        void* stream) {
  if (!pocomc::head_compiled(np)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * (size_t)made_rqs_backward_smem_floats(RL, BM, RNH, RNO, G, BK, S, d, h, np);
  pocomc::k5::Coupling m{nullptr, d, h, T};
  m.np = np;
  m.made_b3 = b3;
  if (!pocomc::k5::k5_args_ok(RL, BM, RNH, RNO, G, BK, S, m, smem))
    return (int)cudaErrorInvalidValue;
  const int cl = RL == 4 ? pocomc::k5::Tile::cols(1) : pocomc::k5::Row::cols(1);
  const PackShape ps{d, h, T, np, G, cl * RNO, cl * RNH};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t total = ps.floats();
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  pack_kernel<<<blocks, 256, 0, s>>>(w0, w1, w2, w3, pack, ps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const pocomc::stack::Args a{
      pocomc::Saved{{const_cast<float*>(a0), const_cast<float*>(a1), const_cast<float*>(a2),
                     const_cast<float*>(a3)}},
      nullptr, gz, gladj, gy, pocomc::stack::Deltas{{g0, g1, g2, g3}, d * np}, n, m,
      pocomc::k5::Packed{pack, pack + ps.w3_floats(), (int)ps.ng()}, G, BK, S, false, smem, s};
#if POCOMC_AFFINE
  if (np == pocomc::AffineHead::NP)
    return pocomc::stack::by_tile<pocomc::AffineHead, false>(RL, BM, RNH, RNO, a);
#endif
  return pocomc::stack::by_tile<pocomc::RqsHead, false>(RL, BM, RNH, RNO, a);
}
