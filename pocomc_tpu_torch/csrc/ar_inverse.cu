// K1: autoregressive inverse of a whole NSF transform stack, latent ->
// data, with the summed log|det dx/dz|.
//
// Replaces the round-2 Pallas kernel of the JAX package, a fused
// whole-transform autoregressive inverse with the masked weights resident
// and all d steps unrolled (never committed; specified in RESULTS.md
// "Pallas postmortem" and pocomc_tpu/models/flow.py:170-184). Its live XLA
// counterpart is flow.py transform_inverse / the reverse scan over
// transforms, made.py apply_made_dim and transforms.py rqs_inverse.
//
// What bounds it on the H100: the T*d sequential steps. Each step is a
// full masked hidden stack for the tile (2*(d*h + 2*h*h) flops per
// particle) plus 23 output columns, and a step cannot start before the
// previous dimension's spline inverse has written x. Across steps nothing
// but a block barrier is paid: the whole stack runs in one launch, the
// tile's x, z, hidden activations and spline parameters stay in shared
// memory, and the masked weights are read through the read-only cache
// (about 39 KB a transform at d=10, h=32; 1.75 MB at d=50, h=256, where
// they come from L2). Parallelism is over particle tiles, so small
// populations fill few SMs; the tile size is chosen by the wrapper.
#include <cuda_runtime.h>

#include "rqs.cuh"

namespace {

using namespace pocomc;

__global__ void ar_inverse_kernel(const float* __restrict__ z, float* __restrict__ x,
                                  float* __restrict__ ladj, int n, int d, int h, int T,
                                  const float* __restrict__ w0, const float* __restrict__ b0,
                                  const float* __restrict__ w1, const float* __restrict__ b1,
                                  const float* __restrict__ w2, const float* __restrict__ b2,
                                  const float* __restrict__ w3, const float* __restrict__ b3,
                                  const int* __restrict__ inv_order, int P) {
  extern __shared__ float smem[];
  float* zs = smem;           // P*d   input of the current transform
  float* xs = zs + P * d;     // P*d   its output, filled dimension by dimension
  float* hs = xs + P * d;     // P*h   hidden pre-activation
  float* ts = hs + P * h;     // P*h   scratch
  float* ps = ts + P * h;     // P*23  spline parameters of the current dimension
  float* ls = ps + P * NPARAMS;  // P  log-det accumulator

  const int row0 = blockIdx.x * P;
  for (int idx = threadIdx.x; idx < P * d; idx += blockDim.x) {
    const int r = row0 + idx / d;
    zs[idx] = r < n ? z[(size_t)row0 * d + idx] : 0.0f;
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) ls[p] = 0.0f;

  const int dout = d * NPARAMS;
  for (int t = T - 1; t >= 0; --t) {
    for (int idx = threadIdx.x; idx < P * d; idx += blockDim.x) xs[idx] = 0.0f;
    __syncthreads();
    const float* w0t = w0 + (size_t)t * d * h;
    const float* b0t = b0 + (size_t)t * h;
    const float* w1t = w1 + (size_t)t * h * h;
    const float* b1t = b1 + (size_t)t * h;
    const float* w2t = w2 + (size_t)t * h * h;
    const float* b2t = b2 + (size_t)t * h;
    const float* w3t = w3 + (size_t)t * h * dout;
    const float* b3t = b3 + (size_t)t * dout;
    for (int k = 0; k < d; ++k) {
      const int dim = inv_order[t * d + k];
      tile_hidden(xs, d, h, w0t, b0t, w1t, b1t, w2t, b2t, hs, ts, P);
      tile_dense<true>(hs, h, w3t, dout, b3t, dim * NPARAMS, NPARAMS, ps, P);
      __syncthreads();
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        float l;
        xs[p * d + dim] = rqs_inverse(zs[p * d + dim], ps + p * NPARAMS, &l);
        ls[p] += l;
      }
      __syncthreads();
    }
    float* tmp = zs;
    zs = xs;
    xs = tmp;
  }

  for (int idx = threadIdx.x; idx < P * d; idx += blockDim.x) {
    const int r = row0 + idx / d;
    if (r < n) x[(size_t)row0 * d + idx] = zs[idx];
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    if (row0 + p < n) ladj[row0 + p] = ls[p];
}

}  // namespace

// Plain C entry point, loaded with ctypes. Weights as for
// made_rqs_forward_launch; inv_order is the (T, d) int32 order in which
// each transform's inverse visits the dimensions (argsort of its
// autoregressive order). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ar_inverse_launch(const float* z, float* x, float* ladj, int n, int d, int h,
                                 int T, const float* w0, const float* b0, const float* w1,
                                 const float* b1, const float* w2, const float* b2,
                                 const float* w3, const float* b3, const int* inv_order,
                                 int tile, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)pocomc::tile_smem_floats(tile, d, h);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ar_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + tile - 1) / tile;
  ar_inverse_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      z, x, ladj, n, d, h, T, w0, b0, w1, b1, w2, b2, w3, b3, inv_order, tile);
  return (int)cudaGetLastError();
}
