// K2: fused MADE + rational-quadratic-spline forward pass of a whole NSF
// transform stack, data -> latent, with the summed log|det dz/dy|.
//
// Replaces the Pallas kernel `_made_kernel` / `_pallas_made_call` /
// `make_made_apply` of pocomc_tpu/ops/pallas_kernels.py (deleted in commit
// 246a898; one whole MADE pass with the mask multiply fused into the
// weight load) and extends it over the spline and the loop over
// transforms, which the JAX package runs as XLA code
// (pocomc_tpu/models/flow.py forward scan, transforms.py rqs_forward).
//
// What bounds it on the H100: fp32 FMA throughput and shared-memory traffic of
// the masked matrix products (about 2 * n * T * (d*h + 2*h*h + h*23*d)
// flops), and, at the main path's small particle counts, launch latency
// and occupancy. Design: one block per tile of P particles keeps the
// activations of all T transforms in shared memory, so a call is one
// launch and the only device-memory traffic is y in, z and ladj out and
// the masked weights, which the read-only cache serves to every block.
// The output layer runs one dimension's 23 columns at a time, so a tile's
// spline parameters never need more than P*23 floats. No tensor cores:
// the flow runs in full fp32 and this first version uses FMA loops only.
#include <cuda_runtime.h>

#include "rqs.cuh"

namespace {

using namespace pocomc;

__global__ void made_rqs_forward_kernel(const float* __restrict__ y, float* __restrict__ z,
                                        float* __restrict__ ladj, int n, int d, int h, int T,
                                        const float* __restrict__ w0,
                                        const float* __restrict__ b0,
                                        const float* __restrict__ w1,
                                        const float* __restrict__ b1,
                                        const float* __restrict__ w2,
                                        const float* __restrict__ b2,
                                        const float* __restrict__ w3,
                                        const float* __restrict__ b3, int P) {
  extern __shared__ float smem[];
  float* xs = smem;           // P*d   input of the current transform
  float* xn = xs + P * d;     // P*d   its output
  float* hs = xn + P * d;     // P*h   hidden pre-activation
  float* ts = hs + P * h;     // P*h   scratch
  float* ps = ts + P * h;     // P*23  spline parameters of one dimension
  float* ls = ps + P * NPARAMS;  // P  log-det accumulator

  const int row0 = blockIdx.x * P;
  for (int idx = threadIdx.x; idx < P * d; idx += blockDim.x) {
    const int r = row0 + idx / d;
    xs[idx] = r < n ? y[(size_t)row0 * d + idx] : 0.0f;
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) ls[p] = 0.0f;
  __syncthreads();

  const int dout = d * NPARAMS;
  for (int t = 0; t < T; ++t) {
    tile_hidden(xs, d, h, w0 + (size_t)t * d * h, b0 + (size_t)t * h,
                w1 + (size_t)t * h * h, b1 + (size_t)t * h, w2 + (size_t)t * h * h,
                b2 + (size_t)t * h, hs, ts, P);
    const float* w3t = w3 + (size_t)t * h * dout;
    const float* b3t = b3 + (size_t)t * dout;
    for (int k = 0; k < d; ++k) {
      tile_dense<true>(hs, h, w3t, dout, b3t, k * NPARAMS, NPARAMS, ps, P);
      __syncthreads();
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        float l;
        xn[p * d + k] = rqs_forward(xs[p * d + k], ps + p * NPARAMS, &l);
        ls[p] += l;
      }
      __syncthreads();
    }
    float* tmp = xs;
    xs = xn;
    xn = tmp;
  }

  for (int idx = threadIdx.x; idx < P * d; idx += blockDim.x) {
    const int r = row0 + idx / d;
    if (r < n) z[(size_t)row0 * d + idx] = xs[idx];
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    if (row0 + p < n) ladj[row0 + p] = ls[p];
}

}  // namespace

// Plain C entry point, loaded with ctypes. Weights are the (T, fan_in,
// fan_out) masked weights and (T, fan_out) biases of the four MADE layers,
// contiguous fp32 on the device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int made_rqs_forward_launch(const float* y, float* z, float* ladj, int n, int d,
                                       int h, int T, const float* w0, const float* b0,
                                       const float* w1, const float* b1, const float* w2,
                                       const float* b2, const float* w3, const float* b3,
                                       int tile, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)pocomc::tile_smem_floats(tile, d, h);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(made_rqs_forward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + tile - 1) / tile;
  made_rqs_forward_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      y, z, ladj, n, d, h, T, w0, b0, w1, b1, w2, b2, w3, b3, tile);
  return (int)cudaGetLastError();
}
