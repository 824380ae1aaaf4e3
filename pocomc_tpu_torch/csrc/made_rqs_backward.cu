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
// layers and the weight-gradient products A^T * g, together 2x the
// forward's flops, plus the output layer's product again (321,024 a row at
// nsf6, d=10, h=32: 4.9 us at n=1024 against the 67 TFLOP/s fp32 peak). At
// the training batch of 1024 rows it is latency: a chain of T transforms,
// each a spline backward and four transposed products, with block barriers
// between.
//
// Design: one block of 256 threads per tile of P particles walks the
// transforms in reverse. For each it reads the input of every layer's
// product that the forward kernel saved (x_t and relu(h0..h2), Saved), so
// nothing of the hidden stack is recomputed. The output layer runs a group
// of G whole dimensions at a time: the group's spline parameters from
// relu(h2), the spline backward of its P*G (row, dim) pairs at once
// (rqs.cuh rqs_forward_vjp, one thread each), and the product of their
// gradients with W3^T into dL/dh2. Where a group's weights fit one ring
// stage (every group at d=10 and d=50) the one chunk serves both products;
// otherwise the group streams twice. Then delta * W^T back through the two
// residual layers (skip path plus ReLU path, the ReLU's mask from the saved
// activations) and the input layer gives dL/dx_t for the transform before.
// Weights stream through the same cp.async ring as the forward's
// (made_tile.cuh), in the order the gradient uses them. The deltas of the
// four layers go to scratch (T, n, .), rows < n only; the wrapper takes the
// weight gradients from them and the saved activations with batched
// products and row sums over T, so no float atomics sit anywhere on the
// gradient path and every run gives the same bits. fp32 FMAs only.
#include <cuda_runtime.h>

#include "made_tile.cuh"

namespace {

using namespace pocomc;

// each layer's output delta g[l] (T, n, N_l), the scratch of the
// weight-gradient products
struct Deltas {
  float* g[4];
};

template <class Head, int RP>
__global__ void __launch_bounds__(THREADS)
    made_rqs_backward_kernel(Saved sv, const float* __restrict__ gz,
                             const float* __restrict__ gladj, float* __restrict__ gy, Deltas dl,
                             int n, Made m, int P, int gw, int SL) {
  extern __shared__ __align__(16) float smem[];
  const int d = m.d, h = m.h, dout = d * Head::NP;
  float* xs = smem;          // P*d   input x_t of the transform
  float* as = xs + P * d;    // P*h   relu(h2), the output layer's input
  float* pg = as + P * h;    // P*gw  one group's spline parameters, then their gradients
  float* gx = pg + P * gw;   // P*d   dL/dx_{t+1}, then dL/dx_t
  float* gd = gx + P * d;    // P*d   dL/dx_t through the spline alone
  float* gh = gd + P * d;    // P*h   dL/dh of the current layer
  float* ga = gh + P * h;    // P*h   product accumulator
  float* gl = ga + P * h;    // P     dL/dladj
  WeightStream ws(m, ring_start(smem, P * (3 * d + 3 * h + gw + 1)), SL, gw, true);
  ws.start();

  const int row0 = blockIdx.x * P;
  for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
    const int r = row0 + idx / d;
    gx[idx] = r < n ? gz[(size_t)row0 * d + idx] : 0.0f;
  }
  for (int p = threadIdx.x; p < P; p += THREADS) gl[p] = row0 + p < n ? gladj[row0 + p] : 0.0f;

  for (int t = m.T - 1; t >= 0; --t) {
    const size_t off = (size_t)t * n;
    for (int idx = threadIdx.x; idx < P * d; idx += THREADS)
      xs[idx] = row0 + idx / d < n ? sv.a[0][(off + row0) * d + idx] : 0.0f;
    for (int idx = threadIdx.x; idx < P * h; idx += THREADS)
      as[idx] = row0 + idx / h < n ? sv.a[3][(off + row0) * h + idx] : 0.0f;
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
        const int k0 = c.g0 / Head::NP, gdim = (c.gend - c.g0) / Head::NP;
        for (int idx = threadIdx.x; idx < P * gdim; idx += THREADS) {
          const int p = idx / gdim, k = k0 + idx - p * gdim;
          gd[p * d + k] = Head::forward_vjp(xs[p * d + k], pg + p * gw + (k - k0) * Head::NP,
                                            gx[p * d + k], gl[p]);
        }
        __syncthreads();
        const int cols = c.gend - c.g0;
        for (int idx = threadIdx.x; idx < P * cols; idx += THREADS) {
          const int p = idx / cols, j = idx - p * cols;
          if (row0 + p < n) dl.g[3][(off + row0 + p) * dout + c.g0 + j] = pg[p * gw + j];
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
    // -- input layer: dL/dx_t = dL/dh0 W0^T + the spline's own
    do {
      const float* Ws = ws.acquire(&c);
      tile_product_t<RP>(gh, h, c.c0, c.nc, Ws, d, ga, d, P, c.c0 == 0);
      ws.release();
    } while (!c.layer_end);
    for (int idx = threadIdx.x; idx < P * d; idx += THREADS) gx[idx] = ga[idx] + gd[idx];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
    const int r = row0 + idx / d;
    if (r < n) gy[(size_t)row0 * d + idx] = gx[idx];
  }
}

template <class Head, int RP>
int launch(const Saved& sv, const float* gz, const float* gladj, float* gy, const Deltas& dl,
           int n, const Made& m, int P, int gw, int SL, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(made_rqs_backward_kernel<Head, RP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  made_rqs_backward_kernel<Head, RP><<<(n + P - 1) / P, THREADS, smem, stream>>>(
      sv, gz, gladj, gy, dl, n, m, P, gw, SL);
  return (int)cudaGetLastError();
}

template <class Head>
int launch_tile(const Saved& sv, const float* gz, const float* gladj, float* gy, const Deltas& dl,
                int n, const Made& m, int P, int gw, int SL, size_t smem, cudaStream_t s) {
  if (P >= 16) return launch<Head, 4>(sv, gz, gladj, gy, dl, n, m, P, gw, SL, smem, s);
  if (P >= 2) return launch<Head, 2>(sv, gz, gladj, gy, dl, n, m, P, gw, SL, smem, s);
  return launch<Head, 1>(sv, gz, gladj, gy, dl, n, m, P, gw, SL, smem, s);
}

}  // namespace

// shared-memory floats of one block: the tile's state, up to 4 floats of
// padding and the ring
extern "C" int made_rqs_backward_smem_floats(int P, int G, int d, int h, int SL, int np) {
  return P * (3 * d + 3 * h + G * np + 1) + 4 + 2 * SL;
}

// Plain C entry point, loaded with ctypes. a0 (T, n, d) and a1..a3
// (T, n, h) are the inputs of every layer's product as the forward kernel
// saved them; gz (n, d) and gladj (n,) are dL/dz and dL/dladj; gy (n, d)
// receives dL/dy and g0..g3 (T, n, h|h|h|d*np) the deltas of the four
// layers. Weights, np, P, G and SL as for made_rqs_forward_launch. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int made_rqs_backward_launch(const float* a0, const float* a1, const float* a2,
                                        const float* a3, const float* gz, const float* gladj,
                                        float* gy, int n, int d, int h, int T, const float* w0,
                                        const float* b0, const float* w1, const float* b1,
                                        const float* w2, const float* b2, const float* w3,
                                        const float* b3, float* g0, float* g1, float* g2,
                                        float* g3, int np, int P, int G, int SL, int device,
                                        void* stream) {
  if (np != pocomc::RqsHead::NP && np != pocomc::AffineHead::NP)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)made_rqs_backward_smem_floats(P, G, d, h, SL, np);
  if (!pocomc::k2_args_ok(P, G, SL, d, h, smem)) return (int)cudaErrorInvalidValue;
  const pocomc::Made m{{w0, w1, w2, w3}, {b0, b1, b2, b3}, d, h, T, np};
  const pocomc::Saved sv{{const_cast<float*>(a0), const_cast<float*>(a1), const_cast<float*>(a2),
                          const_cast<float*>(a3)}};
  const Deltas dl{{g0, g1, g2, g3}};
  const int gw = G * np;
  cudaStream_t s = (cudaStream_t)stream;
  if (np == pocomc::AffineHead::NP)
    return launch_tile<pocomc::AffineHead>(sv, gz, gladj, gy, dl, n, m, P, gw, SL, smem, s);
  return launch_tile<pocomc::RqsHead>(sv, gz, gladj, gy, dl, n, m, P, gw, SL, smem, s);
}
