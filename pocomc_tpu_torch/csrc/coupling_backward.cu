// K5 backward: the gradient of a whole coupling spline stack
// (coupling_forward.cu, data -> latent) with respect to its input and,
// through the layers' deltas, every transform's weights and biases.
//
// Replaces no Pallas kernel: the JAX package takes this gradient with
// jax.value_and_grad of the training loss through the XLA coupling code
// (pocomc_tpu/models/coupling.py, models/flow.py Flow._loss_fn).
//
// What bounds it on the H100: the products back through the four layers
// and the weight-gradient products, 2x the forward's flops, plus the
// output layer's product again. At the training batch of 1024 rows and
// d=10 it is latency: a chain of T transforms, each a spline backward and
// four transposed products, with block barriers between.
//
// Design: K2's backward (made_rqs_backward.cu) over the Coupling network
// of made_tile.cuh. One block of 256 threads per tile of P particles walks
// the transforms in reverse, reading the layer inputs the forward kernel
// saved. The output layer runs a group of G whole transformed dimensions
// at a time: the group's spline parameters from relu(h2), the spline's VJP
// of its P*G (row, dim) pairs (rqs.cuh rqs_forward_vjp, one thread each),
// then their gradients back through W3^T. Then delta * W^T back through
// the residual layers and the input layer, whose fan-in is the
// conditioning half: dL/dx_t of a conditioning column is the net's
// gradient plus the pass-through dL/dx_{t+1}, of a transformed column the
// spline's own. The deltas of the four layers go to scratch (T, n, .),
// rows < n only, the output layer's at the widest transformed half
// (ceil(d/2)*23 columns, the columns a narrower half leaves set to 0); the
// wrapper takes the weight gradients from them and the saved activations
// with batched products and row sums over T, so no float atomics sit on
// the gradient path and every run gives the same bits. fp32 FMAs only.
#include <cuda_runtime.h>

#include "made_tile.cuh"

namespace {

using namespace pocomc;

// each layer's output delta g[l] (T, n, N_l), the output layer's at the
// row width ldo
struct Deltas {
  float* g[4];
  int ldo;
};

template <int RP>
__global__ void __launch_bounds__(THREADS)
    coupling_backward_kernel(Saved sv, const float* __restrict__ gz,
                             const float* __restrict__ gladj, float* __restrict__ gy, Deltas dl,
                             int n, Coupling m, int P, int gw, int SL) {
  extern __shared__ __align__(16) float smem[];
  const int d = m.d, h = m.h, np = RqsHead::NP;
  float* xs = smem;          // P*d   input x_t of the transform
  float* as = xs + P * d;    // P*h   relu(h2), the output layer's input
  float* pg = as + P * h;    // P*gw  one group's spline parameters, then their gradients
  float* gx = pg + P * gw;   // P*d   dL/dx_{t+1}, then dL/dx_t
  float* gd = gx + P * d;    // P*d   dL/dx_t of the transformed columns through the spline
  float* gh = gd + P * d;    // P*h   dL/dh of the current layer
  float* ga = gh + P * h;    // P*h   product accumulator
  float* gl = ga + P * h;    // P     dL/dladj
  WeightStream<Coupling> ws(m, ring_start(smem, P * (3 * d + 3 * h + gw + 1)), SL, gw, true,
                            true);
  ws.start();

  const int row0 = blockIdx.x * P;
  for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
    const int r = row0 + idx / d;
    gx[idx] = r < n ? gz[(size_t)row0 * d + idx] : 0.0f;
  }
  for (int p = threadIdx.x; p < P; p += THREADS) gl[p] = row0 + p < n ? gladj[row0 + p] : 0.0f;

  for (int t = m.T - 1; t >= 0; --t) {
    const int c0 = m.cond0(t), nc = m.n_cond(t), tr0 = m.trans0(t);
    const int dout = m.n_trans(t) * np;
    const size_t off = (size_t)t * n;
    for (int idx = threadIdx.x; idx < P * d; idx += THREADS)
      xs[idx] = row0 + idx / d < n ? sv.a[0][(off + row0) * d + idx] : 0.0f;
    for (int idx = threadIdx.x; idx < P * h; idx += THREADS)
      as[idx] = row0 + idx / h < n ? sv.a[3][(off + row0) * h + idx] : 0.0f;
    // the output delta's columns past this transform's half stay 0
    for (int idx = threadIdx.x; idx < P * (dl.ldo - dout); idx += THREADS) {
      const int p = idx / (dl.ldo - dout), j = dout + idx - p * (dl.ldo - dout);
      if (row0 + p < n) dl.g[3][(off + row0 + p) * dl.ldo + j] = 0.0f;
    }
    // -- output layer, a group at a time: params = relu(h2) W3 + b3, the
    //    spline backward in place over them, then dL/dh2 = sum of g W3^T
    Chunk c;
    do {
      const float* Ws = ws.acquire(&c);
      if (c.pass == 0)
        tile_product<RP, false>(as, h, h, Ws, c.nc, c.c0, P,
                                Out{pg, nullptr, nullptr, gw, c.g0, row0, n});
      if (c.pass == 0 && c.group_end) {
        __syncthreads();
        const int k0 = c.g0 / np, gdim = (c.gend - c.g0) / np;
        for (int idx = threadIdx.x; idx < P * gdim; idx += THREADS) {
          const int p = idx / gdim, k = idx - p * gdim, col = tr0 + k0 + k;
          gd[p * d + col] =
              RqsHead::forward_vjp(xs[p * d + col], pg + p * gw + k * np, gx[p * d + col], gl[p]);
        }
        __syncthreads();
        const int cols = c.gend - c.g0;
        for (int idx = threadIdx.x; idx < P * cols; idx += THREADS) {
          const int p = idx / cols, j = idx - p * cols;
          if (row0 + p < n) dl.g[3][(off + row0 + p) * dl.ldo + c.g0 + j] = pg[p * gw + j];
        }
      }
      if (c.pass == 1 || !ws.twopass)
        tile_product_t<RP>(pg, gw, c.c0 - c.g0, c.nc, Ws, h, ga, h, P, c.c0 == 0);
      ws.release();
    } while (!c.layer_end);
    // -- dL/dh2 = (g W3^T) masked by ReLU'(h2)
    for (int idx = threadIdx.x; idx < P * h; idx += THREADS) {
      const float v = as[idx] > 0.0f ? ga[idx] : 0.0f;
      gh[idx] = v;
      if (row0 + idx / h < n) dl.g[2][(off + row0) * h + idx] = v;
    }
    // -- residual layers l = 2, 1: dL/dh_{l-1} = [skip] dL/dh_l + (dL/dh_l
    //    W_l^T masked by ReLU'(h_{l-1})), relu(h_{l-1}) being the saved a[l]
    for (int l = 2; l >= 1; --l) {
      do {
        const float* Ws = ws.acquire(&c);
        tile_product_t<RP>(gh, h, c.c0, c.nc, Ws, h, ga, h, P, c.c0 == 0);
        ws.release();
      } while (!c.layer_end);
      const float* a = sv.a[l] + (off + row0) * h;
      float* gnext = dl.g[l - 1] + (off + row0) * h;
      for (int idx = threadIdx.x; idx < P * h; idx += THREADS) {
        const bool real = row0 + idx / h < n;
        const float v = gh[idx] + (real && a[idx] > 0.0f ? ga[idx] : 0.0f);
        gh[idx] = v;
        if (real) gnext[idx] = v;
      }
    }
    // -- input layer: the conditioning columns' net gradient dL/dh0 W0^T
    //    (ga[p * d + j], j < nc), plus their pass-through; the transformed
    //    columns take the spline's own
    do {
      const float* Ws = ws.acquire(&c);
      tile_product_t<RP>(gh, h, c.c0, c.nc, Ws, nc, ga, d, P, c.c0 == 0);
      ws.release();
    } while (!c.layer_end);
    for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
      const int p = idx / d, col = idx - p * d;
      gx[idx] = col >= c0 && col < c0 + nc ? ga[p * d + col - c0] + gx[idx] : gd[idx];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
    const int r = row0 + idx / d;
    if (r < n) gy[(size_t)row0 * d + idx] = gx[idx];
  }
}

template <int RP>
int launch(const Saved& sv, const float* gz, const float* gladj, float* gy, const Deltas& dl,
           int n, const Coupling& m, int P, int gw, int SL, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(coupling_backward_kernel<RP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  coupling_backward_kernel<RP><<<(n + P - 1) / P, THREADS, smem, stream>>>(sv, gz, gladj, gy, dl,
                                                                          n, m, P, gw, SL);
  return (int)cudaGetLastError();
}

}  // namespace

// shared-memory floats of one block: the tile's state, up to 4 floats of
// padding and the ring (made_rqs_backward_smem_floats' at NP = 23)
extern "C" int coupling_backward_smem_floats(int P, int G, int d, int h, int SL) {
  return P * (3 * d + 3 * h + G * pocomc::RqsHead::NP + 1) + 4 + 2 * SL;
}

// Plain C entry point, loaded with ctypes. a0 (T, n, d) and a1..a3
// (T, n, h) are the inputs of every layer's product as the forward kernel
// saved them; gz (n, d) and gladj (n,) are dL/dz and dL/dladj; gy (n, d)
// receives dL/dx and g0..g2 (T, n, h), g3 (T, n, ceil(d/2)*23) the deltas
// of the four layers. table, P, G and SL as for coupling_forward_launch.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int coupling_backward_launch(const float* a0, const float* a1, const float* a2,
                                        const float* a3, const float* gz, const float* gladj,
                                        float* gy, int n, int d, int h, int T,
                                        const float* const* table, float* g0, float* g1,
                                        float* g2, float* g3, int P, int G, int SL, int device,
                                        void* stream) {
  if (d < 2 || G > (d + 1) / 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)coupling_backward_smem_floats(P, G, d, h, SL);
  if (!pocomc::k2_args_ok(P, G, SL, d, h, smem)) return (int)cudaErrorInvalidValue;
  const pocomc::Coupling m{table, d, h, T, pocomc::RqsHead::NP};
  const pocomc::Saved sv{{const_cast<float*>(a0), const_cast<float*>(a1), const_cast<float*>(a2),
                          const_cast<float*>(a3)}};
  const Deltas dl{{g0, g1, g2, g3}, m.half() * pocomc::RqsHead::NP};
  const int gw = G * pocomc::RqsHead::NP;
  cudaStream_t s = (cudaStream_t)stream;
  if (P >= 16) return launch<4>(sv, gz, gladj, gy, dl, n, m, P, gw, SL, smem, s);
  if (P >= 2) return launch<2>(sv, gz, gladj, gy, dl, n, m, P, gw, SL, smem, s);
  return launch<1>(sv, gz, gladj, gy, dl, n, m, P, gw, SL, smem, s);
}
