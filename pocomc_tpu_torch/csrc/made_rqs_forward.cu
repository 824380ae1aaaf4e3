// K2 forward: fused MADE + element-transform forward pass of a whole
// masked autoregressive transform stack, data -> latent, with the summed
// log|det dz/dy|. The element transform is the head (heads.cuh), a
// template parameter: the spline of the nsf* flows (3 BINS - 1 parameters
// a dimension, 23 at the default 8 bins; one library a bins up to 16, one
// of run-time bins past that: rqs.cuh) or the affine map of the maf* flows
// (2).
//
// Replaces the Pallas kernel `_made_kernel` / `_pallas_made_call` /
// `make_made_apply` of pocomc_tpu/ops/pallas_kernels.py (deleted in commit
// 246a898; one whole MADE pass with the mask multiply fused into the
// weight load) and extends it over the spline and the loop over
// transforms, which the JAX package runs as XLA code
// (pocomc_tpu/models/flow.py forward scan, transforms.py rqs_forward).
//
// What bounds it on the H100: fp32 FMAs of the masked products,
// 2 * T * (d*h + 2*h*h + h*23*d) flops a row (116,736 at nsf6, d=10, h=32:
// 1.8 us at n=1024 against the 67 TFLOP/s fp32 peak; 21.5 GFLOP, 0.32 ms, at
// d=50, h=256, n=4096); bytes (y in, z and ladj out, the weights once) are
// far below that. At the main path's n=256-4096 a launch is a handful of
// microseconds of latency: the chain of T transforms x 4 layers x spline,
// each step waiting on the last.
//
// Design: one block of 256 threads per tile of P particles (1-16, chosen
// so that n fills the 132 SMs) runs all T transforms in one launch, with
// the tile's activations in shared memory. The masked weights stream
// through a two-stage shared-memory ring with cp.async (made_tile.cuh), so
// the next chunk (the next layer, or the next transform's first) loads
// while this one computes, and every FMA reads its weight from shared
// memory; each thread keeps RP rows of one column in registers, so one
// weight read feeds RP FMAs. The output layer runs a group of G whole
// dimensions at a time (all of them up to d=50, as many as half the shared
// memory holds beyond), each group's P*G splines in parallel right after
// it, one thread each; the tile's shared memory is P*(d + 2h + NP*G + 1)
// floats beside the ring. With `sv` set it also writes
// every layer's input of every transform (Saved), which the backward kernel
// (made_rqs_backward.cu) and the weight-gradient products take. fp32 FMAs
// only: no tensor cores (no TF32), no fast-math.
#include <cuda_runtime.h>

#include "made_tile.cuh"

namespace {

using namespace pocomc;

template <class Head, int RP>
__global__ void __launch_bounds__(THREADS)
    made_rqs_forward_kernel(const float* __restrict__ y, float* __restrict__ z,
                            float* __restrict__ ladj, Saved sv, int n, Made m, int P, int gw,
                            int SL) {
  extern __shared__ __align__(16) float smem[];
  const int d = m.d, h = m.h;
  float* xs = smem;          // P*d   input of the current transform, then its output
  float* hs = xs + P * d;    // P*h   hidden state
  float* hn = hs + P * h;    // P*h   next hidden state; per-dimension log-dets
  float* ps = hn + P * h;    // P*gw  spline parameters of one column group
  float* ls = ps + P * gw;   // P     log-det accumulator
  WeightStream ws(m, ring_start(smem, P * (d + 2 * h + gw + 1)), SL, gw);
  ws.start();
  const bool save = sv.a[0] != nullptr;

  const int row0 = blockIdx.x * P;
  for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
    const int r = row0 + idx / d;
    xs[idx] = r < n ? y[(size_t)row0 * d + idx] : 0.0f;
  }
  for (int p = threadIdx.x; p < P; p += THREADS) ls[p] = 0.0f;
  __syncthreads();

  for (int t = 0; t < m.T; ++t) {
    const size_t off = (size_t)t * n;
    if (save) {
      for (int idx = threadIdx.x; idx < P * d; idx += THREADS)
        if (row0 + idx / d < n) sv.a[0][(off + row0) * d + idx] = xs[idx];
    }
    for (int l = 0; l < 4; ++l) {
      float* act = save && l < 3 ? sv.a[l + 1] + off * h : nullptr;
      Chunk c;
      do {
        const float* Ws = ws.acquire(&c);
        if (l == 0)
          tile_product<RP, false>(xs, d, d, Ws, c.nc, c.c0, P, Out{hs, nullptr, act, h, 0, row0, n});
        else if (l < 3)
          tile_product<RP, true>(hs, h, h, Ws, c.nc, c.c0, P, Out{hn, hs, act, h, 0, row0, n});
        else
          tile_product<RP, true>(hs, h, h, Ws, c.nc, c.c0, P,
                                 Out{ps, nullptr, nullptr, gw, c.g0, row0, n});
        ws.release();
        if (l == 3 && c.group_end) {
          // the group's heads: dimensions k0 .. k0 + gd - 1 of every row
          const int np = Head::RUNTIME ? m.np : Head::NP;
          const int k0 = c.g0 / np, gd = (c.gend - c.g0) / np;
          for (int idx = threadIdx.x; idx < P * gd; idx += THREADS) {
            const int p = idx / gd, k = k0 + idx - p * gd;
            float* pk = ps + p * gw + (k - k0) * np;
            float lg;
            if constexpr (Head::RUNTIME)
              xs[p * d + k] = Head::forward(xs[p * d + k], ParamsAt<1>{pk}, (np + 1) / 3, &lg);
            else
              xs[p * d + k] = Head::forward(xs[p * d + k], pk, &lg);
            hn[p * d + k] = lg;
          }
        }
      } while (!c.layer_end);
      if (l == 1 || l == 2) {
        float* tmp = hs;
        hs = hn;
        hn = tmp;
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += THREADS) {
      float s = 0.0f;
      for (int k = 0; k < d; ++k) s += hn[p * d + k];
      ls[p] += s;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
    const int r = row0 + idx / d;
    if (r < n) z[(size_t)row0 * d + idx] = xs[idx];
  }
  for (int p = threadIdx.x; p < P; p += THREADS)
    if (row0 + p < n) ladj[row0 + p] = ls[p];
}

template <class Head, int RP>
int launch(const float* y, float* z, float* ladj, const Saved& sv, int n, const Made& m, int P,
           int gw, int SL, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(made_rqs_forward_kernel<Head, RP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  made_rqs_forward_kernel<Head, RP><<<(n + P - 1) / P, THREADS, smem, stream>>>(
      y, z, ladj, sv, n, m, P, gw, SL);
  return (int)cudaGetLastError();
}

template <class Head>
int launch_tile(const float* y, float* z, float* ladj, const Saved& sv, int n, const Made& m,
                int P, int gw, int SL, size_t smem, cudaStream_t s) {
  if (P >= 16) return launch<Head, 4>(y, z, ladj, sv, n, m, P, gw, SL, smem, s);
  if (P >= 2) return launch<Head, 2>(y, z, ladj, sv, n, m, P, gw, SL, smem, s);
  return launch<Head, 1>(y, z, ladj, sv, n, m, P, gw, SL, smem, s);
}

}  // namespace

// shared-memory floats of one block with a head of np parameters: the
// tile's state, up to 4 floats of padding and the ring
extern "C" int made_rqs_forward_smem_floats(int P, int G, int d, int h, int SL, int np) {
  return P * (d + 2 * h + G * np + 1) + 4 + 2 * SL;
}

// Plain C entry point, loaded with ctypes. Weights are the (T, fan_in,
// fan_out) masked weights and (T, fan_out) biases of the four MADE layers,
// contiguous fp32 on the device. a0..a3 are all null, or receive the input
// of every layer's product: a0 (T, n, d) the transform inputs, a1..a3
// (T, n, h) relu(h0), relu(h1), relu(h2). np picks the head: 3 BINS - 1
// the library's spline, 2 the affine map (w3 and b3 have d*np columns). P is the tile (1, 2, 4, 8 or 16
// rows), G the dimensions of an output-layer group (1..d), SL the floats of
// one ring stage (a multiple of 4, at least h + 1). Launches on `stream`
// and returns cudaGetLastError().
extern "C" int made_rqs_forward_launch(const float* y, float* z, float* ladj, int n, int d,
                                       int h, int T, const float* w0, const float* b0,
                                       const float* w1, const float* b1, const float* w2,
                                       const float* b2, const float* w3, const float* b3,
                                       float* a0, float* a1, float* a2, float* a3, int np,
                                       int P, int G, int SL, int device, void* stream) {
  if (!pocomc::head_compiled(np)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)made_rqs_forward_smem_floats(P, G, d, h, SL, np);
  if (!pocomc::k2_args_ok(P, G, SL, d, h, smem)) return (int)cudaErrorInvalidValue;
  const pocomc::Made m{{w0, w1, w2, w3}, {b0, b1, b2, b3}, d, h, T, np};
  const pocomc::Saved sv{{a0, a1, a2, a3}};
  const int gw = G * np;
  cudaStream_t s = (cudaStream_t)stream;
#if POCOMC_AFFINE
  if (np == pocomc::AffineHead::NP)
    return launch_tile<pocomc::AffineHead>(y, z, ladj, sv, n, m, P, gw, SL, smem, s);
#endif
  return launch_tile<pocomc::RqsHead>(y, z, ladj, sv, n, m, P, gw, SL, smem, s);
}
