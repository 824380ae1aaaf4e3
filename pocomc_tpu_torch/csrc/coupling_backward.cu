// K5 backward: the gradient of a whole coupling spline stack
// (coupling_forward.cu, data -> latent) with respect to its input and,
// through the layers' deltas, every transform's weights and biases. Its
// inverse instances (INV, K5-inv-bwd) give the gradient of the stack's
// inverse (latent -> data) in its input alone.
//
// Replaces no Pallas kernel: the JAX package takes this gradient with
// jax.value_and_grad of the training loss through the XLA coupling code
// (pocomc_tpu/models/coupling.py, models/flow.py Flow._loss_fn), and the
// inverse's with jax.vjp through Flow.kernel_inv (pocomc_tpu/mcmc.py
// _grad_target) at every step of a preconditioned mala/hmc sweep.
//
// What bounds it on the H100: the products back through the four layers
// and the weight-gradient products, 2x the forward's flops, plus the
// output layer's product again. At the training batch of 1024 rows and
// d=10 it is latency: a chain of T transforms, each a spline backward and
// four transposed products, with block barriers between.
//
// Design: stack_backward.cuh's kernel on the coupling network
// (coupling_tile.cuh Coupling, the halves of make_coupling_masks) with the
// spline head: a producer warp streams the output layer and every W^T from
// the wrapper's packed copies into an S-stage ring, 8 consumer warps hold
// register tiles of BM rows and walk the transforms in reverse over the
// layer inputs the forward kernel saved.
//
// The inverse instances (INV, K5-inv-bwd) run on the state that K5's
// inverse save instance wrote (coupling_forward.cu): each transform's x_t
// as the inverse computed it (the point at which the JAX package's
// jax.vjp differentiates), relu(h0..h2) and the output layer's spline
// parameters, so no K5 forward runs in the gradient and the output layer's
// product is not computed again. They walk transforms 0..T-1 with the
// inverse's element VJP and write no deltas.
#include <cuda_runtime.h>

#include "stack_backward.cuh"

// shared-memory floats of one block (stack_backward.cuh smem_floats)
extern "C" int coupling_backward_smem_floats(int RL, int BM, int RNH, int RNO, int G, int BK,
                                             int S, int d, int h, int np) {
  return pocomc::stack::smem_floats(RL, BM, RNH, RNO, G, BK, S, d, h, np);
}

// Plain C entry point, loaded with ctypes. a0 (T, n, d) and a1..a3
// (T, n, h) are the inputs of every layer's product as the forward kernel
// saved them; gz (n, d) and gladj (n,) are dL/dz and dL/dladj; gy (n, d)
// receives dL/dx and g0..g2 (T, n, h), g3 (T, n, ceil(d/2)*NP) the deltas
// of the four layers. With inverse != 0, the gradient of the inverse:
// a0..a3 and ap (T, n, ceil(d/2)*NP; or null, and the kernel computes the
// parameters from a3) the state K5's inverse save instance wrote, gz and
// gladj dL/dx and dL/dladj of the inverse, gy receives dL/dz, and g0..g3
// are not written (null). table and the tile (RL, BM, RNH, RNO, G, BK, S)
// as for coupling_forward_launch; w3 and wt the weights packed as
// coupling_tile.cuh Packed describes (w3 as for coupling_forward_launch, wt
// each transform's W^T in passes of the hidden pass width; 16-byte
// aligned). np as for coupling_forward_launch. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int coupling_backward_launch(const float* a0, const float* a1, const float* a2,
                                        const float* a3, const float* ap, const float* gz,
                                        const float* gladj, float* gy, int n, int d, int h,
                                        int T, const float* const* table, const float* w3,
                                        const float* wt, float* g0, float* g1, float* g2,
                                        float* g3, int RL, int BM, int RNH, int RNO, int G,
                                        int BK, int S, int inverse, int np, int device,
                                        void* stream) {
  if (w3 == nullptr || wt == nullptr || (!inverse && ap != nullptr) ||
      !pocomc::head_compiled(np) || np == pocomc::AffineHead::NP)
    return (int)cudaErrorInvalidValue;
  if (!inverse && (g0 == nullptr || g1 == nullptr || g2 == nullptr || g3 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * (size_t)coupling_backward_smem_floats(RL, BM, RNH, RNO, G, BK, S, d, h, np);
  pocomc::k5::Coupling m{table, d, h, T};
  m.np = np;
  if (!pocomc::k5::k5_args_ok(RL, BM, RNH, RNO, G, BK, S, m, smem))
    return (int)cudaErrorInvalidValue;
  const pocomc::stack::Args a{
      pocomc::Saved{{const_cast<float*>(a0), const_cast<float*>(a1), const_cast<float*>(a2),
                     const_cast<float*>(a3)}},
      ap, gz, gladj, gy, pocomc::stack::Deltas{{g0, g1, g2, g3}, m.half() * np},
      n, m, pocomc::k5::Packed{w3, wt, ((d + 1) / 2 + G - 1) / G}, G, BK, S, inverse != 0, smem,
      (cudaStream_t)stream};
  return pocomc::stack::by_tile<pocomc::RqsHead, true>(RL, BM, RNH, RNO, a);
}
