// Shared device code of the flow kernels (made_rqs_forward.cu, ar_inverse.cu):
// the 8-bin rational-quadratic spline (spline setup, bin search, forward,
// inverse) and the masked dense layers of a MADE pass over a particle tile.
//
// The spline math follows pocomc_tpu/models/transforms.py term for term, in
// fp32 with plain FMA arithmetic (no fast-math intrinsics): knots from a
// softmax with a MIN_BIN floor and a running sum, last knot forced to +B,
// derivatives MIN_DERIV + softplus(raw + shift) with unit end derivatives,
// the bin index as the count of interior knots <= position, identity with
// zero log-det outside (-B, B), and the stable inverse root
// xi = 2c / (-b - sqrt(max(disc, 0))) clipped to [0, 1].
#pragma once

#include <math.h>

namespace pocomc {

constexpr int BINS = 8;
constexpr int NPARAMS = 3 * BINS - 1;           // raw parameters per dimension
constexpr float SPLINE_BOUND = 5.0f;
constexpr float MIN_BIN = 1e-3f;
constexpr float MIN_DERIV = 1e-3f;
// shift such that MIN_DERIV + softplus(0 + shift) == 1: zero weights give
// the identity map
constexpr float SOFTPLUS_INV_1 = 0.5397424172369522f;

// log(1 + exp(x)) without a linear cut-over (jax.nn.softplus)
__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// softmax bin sizes -> BINS + 1 knot positions on [-B, B]
__device__ __forceinline__ void spline_knots(const float* raw, float* k) {
  const float B = SPLINE_BOUND;
  float m = raw[0];
#pragma unroll
  for (int i = 1; i < BINS; ++i) m = fmaxf(m, raw[i]);
  float e[BINS];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < BINS; ++i) {
    e[i] = expf(raw[i] - m);
    s += e[i];
  }
  float c = 0.0f;
  k[0] = -B;
#pragma unroll
  for (int i = 0; i < BINS; ++i) {
    c += (MIN_BIN + (1.0f - MIN_BIN * BINS) * (e[i] / s)) * (2.0f * B);
    k[i + 1] = c - B;
  }
  k[BINS] = B;
}

__device__ __forceinline__ void spline_setup(const float* p, float* xk, float* yk,
                                             float* dv) {
  spline_knots(p, xk);
  spline_knots(p + BINS, yk);
  dv[0] = 1.0f;
#pragma unroll
  for (int i = 0; i < BINS - 1; ++i)
    dv[i + 1] = MIN_DERIV + softplusf(p[2 * BINS + i] + SOFTPLUS_INV_1);
  dv[BINS] = 1.0f;
}

// count of interior knots <= pos, clipped to [0, BINS - 1]
__device__ __forceinline__ int spline_bin(float pos, const float* k) {
  int idx = 0;
#pragma unroll
  for (int i = 1; i < BINS; ++i) idx += (pos >= k[i]) ? 1 : 0;
  return min(max(idx, 0), BINS - 1);
}

// x -> y; *ladj = log|dy/dx|
__device__ __forceinline__ float rqs_forward(float x, const float* p, float* ladj) {
  const float B = SPLINE_BOUND;
  float xk[BINS + 1], yk[BINS + 1], dv[BINS + 1];
  spline_setup(p, xk, yk, dv);
  const bool inside = (x > -B) && (x < B);
  const float xc = fminf(fmaxf(x, -B + 1e-6f), B - 1e-6f);
  const int i = spline_bin(xc, xk);
  const float x0 = xk[i], x1 = xk[i + 1], y0 = yk[i], y1 = yk[i + 1];
  const float d0 = dv[i], d1 = dv[i + 1];
  const float w = x1 - x0;
  const float h = y1 - y0;
  const float s = h / w;
  const float xi = (xc - x0) / w;
  const float xi1m = 1.0f - xi;
  const float denom = s + (d1 + d0 - 2.0f * s) * xi * xi1m;
  const float y = y0 + h * (s * xi * xi + d0 * xi * xi1m) / denom;
  const float dydx = s * s * (d1 * xi * xi + 2.0f * s * xi * xi1m + d0 * xi1m * xi1m) /
                     (denom * denom);
  *ladj = inside ? logf(dydx) : 0.0f;
  return inside ? y : x;
}

// y -> x; *ladj = log|dx/dy|
__device__ __forceinline__ float rqs_inverse(float y, const float* p, float* ladj) {
  const float B = SPLINE_BOUND;
  float xk[BINS + 1], yk[BINS + 1], dv[BINS + 1];
  spline_setup(p, xk, yk, dv);
  const bool inside = (y > -B) && (y < B);
  const float yc = fminf(fmaxf(y, -B + 1e-6f), B - 1e-6f);
  const int i = spline_bin(yc, yk);
  const float x0 = xk[i], x1 = xk[i + 1], y0 = yk[i], y1 = yk[i + 1];
  const float d0 = dv[i], d1 = dv[i + 1];
  const float w = x1 - x0;
  const float h = y1 - y0;
  const float s = h / w;
  const float dy = yc - y0;
  const float t = d1 + d0 - 2.0f * s;
  const float a = h * (s - d0) + dy * t;
  const float b = h * d0 - dy * t;
  const float c = -s * dy;
  const float disc = fmaxf(b * b - 4.0f * a * c, 0.0f);
  float xi = 2.0f * c / (-b - sqrtf(disc));
  xi = fminf(fmaxf(xi, 0.0f), 1.0f);
  const float x = x0 + xi * w;
  const float xi1m = 1.0f - xi;
  const float denom = s + t * xi * xi1m;
  const float dydx = s * s * (d1 * xi * xi + 2.0f * s * xi * xi1m + d0 * xi1m * xi1m) /
                     (denom * denom);
  *ladj = inside ? -logf(dydx) : 0.0f;
  return inside ? x : y;
}

// One masked dense layer over a tile of P particle rows held in shared
// memory: out[p, j] = sum_i act(in[p, i]) * W[i, col0 + j] + b[col0 + j]
// for j < ncols, act = ReLU when RELU. W is row-major with leading
// dimension ld and already multiplied by its MADE mask. Neighbouring
// threads take neighbouring columns, so the weight reads of a warp are
// coalesced and the activation read is a shared-memory broadcast.
template <bool RELU>
__device__ __forceinline__ void tile_dense(const float* in, int fi, const float* __restrict__ W,
                                           int ld, const float* __restrict__ b, int col0,
                                           int ncols, float* out, int P) {
  for (int idx = threadIdx.x; idx < P * ncols; idx += blockDim.x) {
    const int p = idx / ncols;
    const int j = idx - p * ncols;
    const float* a = in + p * fi;
    const float* wc = W + col0 + j;
    float acc = 0.0f;
    for (int i = 0; i < fi; ++i) {
      float v = a[i];
      if (RELU) v = fmaxf(v, 0.0f);
      acc = fmaf(v, __ldg(wc + (size_t)i * ld), acc);
    }
    out[idx] = acc + __ldg(b + col0 + j);
  }
}

// Hidden stack of one MADE pass (pocomc_tpu/models/made.py _hidden_stack):
// hs = x @ W0 + b0, then two residual layers hs += relu(hs) @ Wl + bl.
// ts is scratch of the same size as hs. Ends synchronised.
__device__ __forceinline__ void tile_hidden(const float* xs, int d, int h,
                                            const float* __restrict__ w0,
                                            const float* __restrict__ b0,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ b1,
                                            const float* __restrict__ w2,
                                            const float* __restrict__ b2, float* hs,
                                            float* ts, int P) {
  tile_dense<false>(xs, d, w0, h, b0, 0, h, hs, P);
  __syncthreads();
  const float* wl[2] = {w1, w2};
  const float* bl[2] = {b1, b2};
  for (int l = 0; l < 2; ++l) {
    tile_dense<true>(hs, h, wl[l], h, bl[l], 0, h, ts, P);
    __syncthreads();
    for (int idx = threadIdx.x; idx < P * h; idx += blockDim.x) hs[idx] += ts[idx];
    __syncthreads();
  }
}

// shared-memory floats of one block of either kernel
__host__ __device__ __forceinline__ int tile_smem_floats(int P, int d, int h) {
  return P * (2 * d + 2 * h + NPARAMS + 1);
}

}  // namespace pocomc
