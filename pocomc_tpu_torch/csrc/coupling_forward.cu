// K5 forward and inverse: a whole stack of T coupling spline transforms
// (the nsfc* flows, models/coupling.py) in one launch, in either
// direction, with the summed log-det.
//
// Replaces no Pallas kernel: the JAX package computes coupling transforms
// as XLA code (pocomc_tpu/models/coupling.py coupling_forward and
// coupling_inverse, the loop over transforms in models/flow.py). A coupling
// transform conditions a residual MLP on one half of the dimensions and
// maps the other half through 8-bin rational-quadratic splines whose
// parameters the MLP gives, so both directions are one pass a transform:
// data -> latent runs transforms 0..T-1 with the spline forward, latent ->
// data runs T-1..0 with the spline inverse.
//
// What bounds it on the H100: fp32 FMAs of the four dense products,
// 2 * T * (n_cond*h + 2*h*h + h*23*n_trans) flops a row (70,656 at nsfc6,
// d=10, h=32; 284,672 a transform at d=50, h=256: 4.5e11 flops, 6.7 ms at
// the 67 TFLOP/s fp32 peak, for 12 transforms and 65,536 rows). At the
// sweep's n=256-4096 and d=10 a launch is latency: T transforms of four
// dependent products and a spline each.
//
// Design: K2's forward (made_rqs_forward.cu) over the Coupling network of
// made_tile.cuh. One block of 256 threads per tile of P particles runs all
// T transforms, the tile's rows in shared memory; each transform's layer 0
// reads the conditioning columns in place (an offset into the row), its
// output layer runs a group of G whole transformed dimensions at a time
// and each group's P*G splines right after it, one thread each, writing
// the transformed columns in place; the conditioning columns are never
// written, so they pass through bit for bit. Weights stream through
// WeightStream's two-stage cp.async ring, in the walk's order of
// transforms; each transform's weights are its own tensors, read through
// a device table of 8T pointers. With `sv` set (the forward only) it also
// writes every layer's input of every transform, (T, n, d) x_t and
// (T, n, h) relu(h0..h2), which the backward kernel
// (coupling_backward.cu) and the weight-gradient products take. fp32 FMAs
// only: no tensor cores, no fast-math.
#include <cuda_runtime.h>

#include "made_tile.cuh"

namespace {

using namespace pocomc;

template <bool INVERSE, int RP>
__global__ void __launch_bounds__(THREADS)
    coupling_kernel(const float* __restrict__ xin, float* __restrict__ xout,
                    float* __restrict__ ladj, Saved sv, int n, Coupling m, int P, int gw,
                    int SL) {
  extern __shared__ __align__(16) float smem[];
  const int d = m.d, h = m.h;
  float* xs = smem;          // P*d   the rows, transformed in place
  float* hs = xs + P * d;    // P*h   hidden state
  float* hn = hs + P * h;    // P*h   next hidden state; per-dimension log-dets
  float* ps = hn + P * h;    // P*gw  spline parameters of one column group
  float* ls = ps + P * gw;   // P     log-det accumulator
  WeightStream<Coupling> ws(m, ring_start(smem, P * (d + 2 * h + gw + 1)), SL, gw, false,
                            INVERSE);
  ws.start();
  const bool save = sv.a[0] != nullptr;

  const int row0 = blockIdx.x * P;
  for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
    const int r = row0 + idx / d;
    xs[idx] = r < n ? xin[(size_t)row0 * d + idx] : 0.0f;
  }
  for (int p = threadIdx.x; p < P; p += THREADS) ls[p] = 0.0f;
  __syncthreads();

  for (int i = 0; i < m.T; ++i) {
    const int t = INVERSE ? m.T - 1 - i : i;
    const int c0 = m.cond0(t), nc = m.n_cond(t), tr0 = m.trans0(t), ntr = m.n_trans(t);
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
          tile_product<RP, false>(xs + c0, d, nc, Ws, c.nc, c.c0, P,
                                  Out{hs, nullptr, act, h, 0, row0, n});
        else if (l < 3)
          tile_product<RP, true>(hs, h, h, Ws, c.nc, c.c0, P, Out{hn, hs, act, h, 0, row0, n});
        else
          tile_product<RP, true>(hs, h, h, Ws, c.nc, c.c0, P,
                                 Out{ps, nullptr, nullptr, gw, c.g0, row0, n});
        ws.release();
        if (l == 3 && c.group_end) {
          // the group's splines: transformed dimensions k0 .. k0 + gd - 1
          const int k0 = c.g0 / RqsHead::NP, gd = (c.gend - c.g0) / RqsHead::NP;
          for (int idx = threadIdx.x; idx < P * gd; idx += THREADS) {
            const int p = idx / gd, k = k0 + idx - p * gd;
            const float* pk = ps + p * gw + (k - k0) * RqsHead::NP;
            float* x = xs + p * d + tr0 + k;
            float lg;
            *x = INVERSE ? RqsHead::inverse(*x, pk, &lg) : RqsHead::forward(*x, pk, &lg);
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
      for (int k = 0; k < ntr; ++k) s += hn[p * d + k];
      ls[p] += s;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < P * d; idx += THREADS) {
    const int r = row0 + idx / d;
    if (r < n) xout[(size_t)row0 * d + idx] = xs[idx];
  }
  for (int p = threadIdx.x; p < P; p += THREADS)
    if (row0 + p < n) ladj[row0 + p] = ls[p];
}

template <bool INVERSE, int RP>
int launch(const float* xin, float* xout, float* ladj, const Saved& sv, int n,
           const Coupling& m, int P, int gw, int SL, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(coupling_kernel<INVERSE, RP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  coupling_kernel<INVERSE, RP><<<(n + P - 1) / P, THREADS, smem, stream>>>(xin, xout, ladj, sv, n,
                                                                          m, P, gw, SL);
  return (int)cudaGetLastError();
}

template <bool INVERSE>
int launch_tile(const float* xin, float* xout, float* ladj, const Saved& sv, int n,
                const Coupling& m, int P, int gw, int SL, size_t smem, cudaStream_t s) {
  if (P >= 16) return launch<INVERSE, 4>(xin, xout, ladj, sv, n, m, P, gw, SL, smem, s);
  if (P >= 2) return launch<INVERSE, 2>(xin, xout, ladj, sv, n, m, P, gw, SL, smem, s);
  return launch<INVERSE, 1>(xin, xout, ladj, sv, n, m, P, gw, SL, smem, s);
}

}  // namespace

// shared-memory floats of one block: the tile's state, up to 4 floats of
// padding and the ring (made_rqs_forward_smem_floats' at NP = 23)
extern "C" int coupling_forward_smem_floats(int P, int G, int d, int h, int SL) {
  return P * (d + 2 * h + G * pocomc::RqsHead::NP + 1) + 4 + 2 * SL;
}

// Plain C entry point, loaded with ctypes. table holds the 8T device
// pointers of the T coupling transforms' fp32 weights and biases (w0 b0
// w1 b1 w2 b2 w3 b3 of each; w0 (n_cond_t, h), w3 (h, n_trans_t*23), the
// halves of make_coupling_masks). inverse = 0 maps data -> latent through
// transforms 0..T-1 (the spline forward, ladj = log|dz/dx|), 1 latent ->
// data through T-1..0 (ladj = log|dx/dz|). a0..a3 are all null, or
// (forward only) receive the input of every layer's product: a0 (T, n, d)
// the transform inputs, a1..a3 (T, n, h) relu(h0), relu(h1), relu(h2). P,
// G (whole transformed dimensions an output group, 1..ceil(d/2)) and SL as
// for made_rqs_forward_launch. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int coupling_forward_launch(const float* xin, float* xout, float* ladj, int n, int d,
                                       int h, int T, const float* const* table, float* a0,
                                       float* a1, float* a2, float* a3, int inverse, int P,
                                       int G, int SL, int device, void* stream) {
  if (d < 2 || G > (d + 1) / 2 || (inverse && a0 != nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)coupling_forward_smem_floats(P, G, d, h, SL);
  if (!pocomc::k2_args_ok(P, G, SL, d, h, smem)) return (int)cudaErrorInvalidValue;
  const pocomc::Coupling m{table, d, h, T, pocomc::RqsHead::NP};
  const pocomc::Saved sv{{a0, a1, a2, a3}};
  const int gw = G * pocomc::RqsHead::NP;
  cudaStream_t s = (cudaStream_t)stream;
  if (inverse) return launch_tile<true>(xin, xout, ladj, sv, n, m, P, gw, SL, smem, s);
  return launch_tile<false>(xin, xout, ladj, sv, n, m, P, gw, SL, smem, s);
}
