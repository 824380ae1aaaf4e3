// Shared device code of the flow kernels: the rational-quadratic spline
// (spline setup, bin search, forward, the vector-Jacobian products of the
// forward and of the inverse, inverse) for all of them. The products are
// the kernels' own: K2's in made_tile.cuh, K1's in ar_inverse.cu and
// ar_inverse_backward.cu, K5's in coupling_tile.cuh.
//
// A library holds one of two splines (ops/_build.py builds one a source
// and kind):
// - bins a compile-time constant, BINS = POCOMC_BINS (2-16, 8 unless the
//   build defines it): every array of the fixed-bins section has a fixed
//   size and stays in registers;
// - bins a run-time value (POCOMC_BINS=0: the library of every bins > 16,
//   the run-time section at the end): its functions take a dimension's
//   3 bins - 1 raw parameters where the kernel keeps them and stream over
//   them, so no array is sized by the bins.
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

// The affine head's instances are the same in every library, so only the
// default one (POCOMC_BINS not defined by the build) compiles them.
#ifdef POCOMC_BINS
#define POCOMC_AFFINE 0
#else
#define POCOMC_BINS 8
#define POCOMC_AFFINE 1
#endif
#if POCOMC_BINS == 0
#define POCOMC_RUNTIME_BINS 1
#else
#define POCOMC_RUNTIME_BINS 0
#endif

constexpr bool RUNTIME_BINS = POCOMC_RUNTIME_BINS;
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


// The rational quadratic of one bin (width w = x1 - x0, height h = y1 -
// y0, derivatives d0, d1 at its edges): y at dx = xc - x0 in [0, w], and
// dy/dx in *dydx
__device__ __forceinline__ float bin_forward(float dx, float w, float y0, float h, float d0,
                                             float d1, float* dydx) {
  const float s = h / w;
  const float xi = dx / w;
  const float xi1m = 1.0f - xi;
  const float denom = s + (d1 + d0 - 2.0f * s) * xi * xi1m;
  const float y = y0 + h * (s * xi * xi + d0 * xi * xi1m) / denom;
  *dydx = s * s * (d1 * xi * xi + 2.0f * s * xi * xi1m + d0 * xi1m * xi1m) / (denom * denom);
  return y;
}

// its inverse: x at dy = yc - y0 in [0, h], and dy/dx there in *dydx
__device__ __forceinline__ float bin_inverse(float dy, float x0, float w, float h, float d0,
                                             float d1, float* dydx) {
  const float s = h / w;
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
  *dydx = s * s * (d1 * xi * xi + 2.0f * s * xi * xi1m + d0 * xi1m * xi1m) / (denom * denom);
  return x;
}

// The local quantities of the bin that holds x as the vector-Jacobian
// products need them, set from the bin's knots and derivatives (x in
// (-B, B)); the arithmetic of rqs_forward_vjp below (models/transforms.py
// rqs_forward_vjp), which keeps its own copy: its bits are a record (K2's
// and K5's backwards, the runs they train), and merging the two moved them.
struct BinVjp {
  int i;
  float w, h, s, xi, xi1m, c, q, denom, num, n2, d0, d1;
  bool in_clamp;  // x in [-B+1e-6, B-1e-6], where clamp passes the gradient

  // the gradients of the bin's knots (x0, x1, y0, y1), derivatives (d0,
  // d1) and of the clamped position xc
  struct KnotGrads {
    float x0, x1, y0, y1, d0, d1, xc;
  };

  // from x (its clamp), dx = xc - x0, the bin's width and height
  __device__ __forceinline__ void set(float x, float dx, float w_, float h_, float d0_,
                                      float d1_) {
    const float B = SPLINE_BOUND;
    in_clamp = x >= -B + 1e-6f && x <= B - 1e-6f;
    d0 = d0_;
    d1 = d1_;
    w = w_;
    h = h_;
    s = h / w;
    xi = dx / w;
    xi1m = 1.0f - xi;
    c = d1 + d0 - 2.0f * s;
    q = xi * xi1m;
    denom = s + c * q;
    num = s * xi * xi + d0 * q;
    n2 = d1 * xi * xi + 2.0f * s * q + d0 * xi1m * xi1m;
  }

  // dy/dx, the slope the forward's log-det is the log of
  __device__ __forceinline__ float slope() const { return s * s * n2 / (denom * denom); }

  // d(ladj)/dx: the log-slope's gradient in x (0 outside the clamp range)
  __device__ __forceinline__ float log_slope_dx() const {
    const float g_n2 = 1.0f / n2;
    const float g_den = -2.0f / denom;
    float g_xi = g_n2 * 2.0f * d1 * xi;
    const float g_q = g_n2 * 2.0f * s + g_den * c;
    float g_xi1m = g_n2 * 2.0f * d0 * xi1m;
    g_xi = g_xi + g_q * xi1m;
    g_xi1m = g_xi1m + g_q * xi;
    g_xi = g_xi - g_xi1m;
    return in_clamp ? g_xi / w : 0.0f;
  }

  // given gy = dL/dy and gl = dL/dladj, the gradients of the bin's knots,
  // derivatives and clamped position
  __device__ __forceinline__ KnotGrads knot_grads(float gy, float gl) const {
    // ladj = 2 log s + log n2 - 2 log denom; y = y0 + h * num / denom
    float g_s = 2.0f * gl / s;
    const float g_n2 = gl / n2;
    const float g_den = -2.0f * gl / denom - gy * h * num / (denom * denom);
    float g_y0 = gy;
    float g_h = gy * num / denom;
    const float g_num = gy * h / denom;
    float g_d1 = g_n2 * xi * xi;
    float g_xi = g_n2 * 2.0f * d1 * xi + g_num * 2.0f * s * xi;
    g_s = g_s + g_n2 * 2.0f * q + g_num * xi * xi + g_den;
    const float g_q = g_n2 * 2.0f * s + g_num * d0 + g_den * c;
    float g_d0 = g_n2 * xi1m * xi1m + g_num * q;
    float g_xi1m = g_n2 * 2.0f * d0 * xi1m;
    const float g_c = g_den * q;
    g_d1 = g_d1 + g_c;
    g_d0 = g_d0 + g_c;
    g_s = g_s - 2.0f * g_c;
    g_xi = g_xi + g_q * xi1m;
    g_xi1m = g_xi1m + g_q * xi;
    g_xi = g_xi - g_xi1m;
    const float g_xc = g_xi / w;
    float g_x0 = -g_xi / w;
    float g_w = -g_xi * xi / w;
    g_h = g_h + g_s / w;
    g_w = g_w - g_s * s / w;
    const float g_y1 = g_h;
    g_y0 = g_y0 - g_h;
    const float g_x1 = g_w;
    g_x0 = g_x0 - g_w;
    return {g_x0, g_x1, g_y0, g_y1, g_d0, g_d1, g_xc};
  }
};

// Views of a dimension's raw parameters for the run-time spline (declared
// in every library, so that the kernels' discarded run-time branches
// name them): p[i * STRIDE] where a kernel keeps them in shared memory,
// or global memory through the read-only cache.
template <int STRIDE>
struct ParamsAt {
  float* p;
  __device__ __forceinline__ float& operator[](int i) const { return p[i * STRIDE]; }
};

struct ParamsLdg {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const { return __ldg(p + i); }
};

// ---------------------------------------------------------------------------
// fixed bins: BINS = POCOMC_BINS, 2-16
// ---------------------------------------------------------------------------
#if !POCOMC_RUNTIME_BINS
constexpr int BINS = POCOMC_BINS;
static_assert(BINS >= 2 && BINS <= 16, "a compile-time spline takes 2-16 bins");
constexpr int NPARAMS = 3 * BINS - 1;           // raw parameters per dimension
// the warp-wide versions (K1's rqs_inverse_warp, rqs_inverse_vjp_warp) hold
// a raw parameter a lane and x in lane NPARAMS: up to 10 bins
constexpr bool WARP_SPLINE = NPARAMS + 1 <= 32;
// bins a lane of rqs_inverse_vjp_group's 8 lanes a row
constexpr int SLICE_BINS = (BINS + 7) / 8;

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

// a[i] and a[i + 1] by unrolled selects, so the knot arrays stay in
// registers (a runtime index would put them in local memory)
__device__ __forceinline__ void bin_edges(const float* a, int i, float* lo, float* hi) {
  float l = a[0], h = a[1];
#pragma unroll
  for (int j = 1; j < BINS; ++j) {
    if (j == i) {
      l = a[j];
      h = a[j + 1];
    }
  }
  *lo = l;
  *hi = h;
}

// x -> y; *ladj = log|dy/dx|
__device__ __forceinline__ float rqs_forward(float x, const float* p, float* ladj) {
  const float B = SPLINE_BOUND;
  float xk[BINS + 1], yk[BINS + 1], dv[BINS + 1];
  spline_setup(p, xk, yk, dv);
  const bool inside = (x > -B) && (x < B);
  const float xc = fminf(fmaxf(x, -B + 1e-6f), B - 1e-6f);
  const int i = spline_bin(xc, xk);
  float x0, x1, y0, y1, d0, d1;
  bin_edges(xk, i, &x0, &x1);
  bin_edges(yk, i, &y0, &y1);
  bin_edges(dv, i, &d0, &d1);
  float dydx;
  const float y = bin_forward(xc - x0, x1 - x0, y0, y1 - y0, d0, d1, &dydx);
  *ladj = inside ? logf(dydx) : 0.0f;
  return inside ? y : x;
}

// The spline of raw parameters p at x as the inverse's vector-Jacobian
// product needs it: the two softmaxes, the sigmoids of the derivatives' raw
// parameters, the bin and its local quantities (BinVjp); x must lie in
// (-B, B). A warp-wide caller (rqs_inverse_vjp_warp) builds the knots
// itself and takes only local() and knot_grads().
struct SplineVjp : BinVjp {
  float sm[2][BINS], sig[BINS - 1];

  SplineVjp() = default;

  __device__ __forceinline__ SplineVjp(float x, const float* p) {
    const float B = SPLINE_BOUND;
    // knots exactly as spline_knots, keeping the two softmaxes
    float kn[2][BINS + 1];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float* raw = p + a * BINS;
      float m = raw[0];
#pragma unroll
      for (int j = 1; j < BINS; ++j) m = fmaxf(m, raw[j]);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        sm[a][j] = expf(raw[j] - m);
        sum += sm[a][j];
      }
      float run = 0.0f;
      kn[a][0] = -B;
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        sm[a][j] = sm[a][j] / sum;
        run += (MIN_BIN + (1.0f - MIN_BIN * BINS) * sm[a][j]) * (2.0f * B);
        kn[a][j + 1] = run - B;
      }
      kn[a][BINS] = B;
    }
    float dv[BINS + 1];
    dv[0] = 1.0f;
#pragma unroll
    for (int j = 0; j < BINS - 1; ++j) {
      const float zr = p[2 * BINS + j] + SOFTPLUS_INV_1;
      dv[j + 1] = MIN_DERIV + softplusf(zr);
      sig[j] = 1.0f / (1.0f + expf(-zr));
    }
    dv[BINS] = 1.0f;
    local(x, kn[0], kn[1], dv);
  }

  // the bin of x and its local quantities, from the knots and derivatives
  __device__ __forceinline__ void local(float x, const float* xk, const float* yk,
                                        const float* dv) {
    const float B = SPLINE_BOUND;
    const float xc = fminf(fmaxf(x, -B + 1e-6f), B - 1e-6f);
    i = spline_bin(xc, xk);
    float x0, x1, y0, y1, e0, e1;
    bin_edges(xk, i, &x0, &x1);
    bin_edges(yk, i, &y0, &y1);
    bin_edges(dv, i, &e0, &e1);
    set(x, xc - x0, x1 - x0, y1 - y0, e0, e1);
  }

  // given gy = dL/dy and gl = dL/dladj, writes dL/dp into p and returns
  // dL/dx
  __device__ __forceinline__ float vjp(float gy, float gl, float* p) const {
    const KnotGrads kg = knot_grads(gy, gl);
    // knot j (1..BINS-1) is the running sum of bin sizes 0..j-1, so bin
    // size m collects the gradients of knots m+1..BINS-1; then the softmax
    const float B = SPLINE_BOUND;
    const float g0[2] = {kg.x0, kg.y0}, g1[2] = {kg.x1, kg.y1};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float gsm[BINS];
      float dot = 0.0f;
#pragma unroll
      for (int m = 0; m < BINS; ++m) {
        const float gsize = (m < i ? g0[a] : 0.0f) + ((m <= i && i <= BINS - 2) ? g1[a] : 0.0f);
        gsm[m] = gsize * ((1.0f - MIN_BIN * BINS) * (2.0f * B));
        dot += sm[a][m] * gsm[m];
      }
#pragma unroll
      for (int m = 0; m < BINS; ++m) p[a * BINS + m] = sm[a][m] * (gsm[m] - dot);
    }
#pragma unroll
    for (int k = 1; k < BINS; ++k) {
      const float gd = (k == i ? kg.d0 : 0.0f) + (k == i + 1 ? kg.d1 : 0.0f);
      p[2 * BINS + k - 1] = gd * sig[k - 1];
    }
    return in_clamp ? kg.xc : 0.0f;
  }
};

// Vector-Jacobian product of rqs_forward for one element, the arithmetic of
// models/transforms.py rqs_forward_vjp: given gy = dL/dy and gl = dL/dladj,
// overwrites the NPARAMS raw parameters p with dL/dp and returns dL/dx.
// Conventions of autograd through the plain forward: knots 0 and BINS are
// constants, clamp passes the gradient on [-B+1e-6, B-1e-6] inclusive, the
// bin index is piecewise constant, and outside (-B, B) the map is the
// identity with zero parameter gradients.
__device__ __forceinline__ float rqs_forward_vjp(float x, float* p, float gy, float gl) {
  const float B = SPLINE_BOUND;
  if (!((x > -B) && (x < B))) {
#pragma unroll
    for (int i = 0; i < NPARAMS; ++i) p[i] = 0.0f;
    return gy;
  }
  // knots exactly as spline_knots, keeping the two softmaxes
  float sm[2][BINS], kn[2][BINS + 1];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float* raw = p + a * BINS;
    float m = raw[0];
#pragma unroll
    for (int i = 1; i < BINS; ++i) m = fmaxf(m, raw[i]);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < BINS; ++i) {
      sm[a][i] = expf(raw[i] - m);
      s += sm[a][i];
    }
    float c = 0.0f;
    kn[a][0] = -B;
#pragma unroll
    for (int i = 0; i < BINS; ++i) {
      sm[a][i] = sm[a][i] / s;
      c += (MIN_BIN + (1.0f - MIN_BIN * BINS) * sm[a][i]) * (2.0f * B);
      kn[a][i + 1] = c - B;
    }
    kn[a][BINS] = B;
  }
  float dv[BINS + 1], sig[BINS - 1];
  dv[0] = 1.0f;
#pragma unroll
  for (int i = 0; i < BINS - 1; ++i) {
    const float zr = p[2 * BINS + i] + SOFTPLUS_INV_1;
    dv[i + 1] = MIN_DERIV + softplusf(zr);
    sig[i] = 1.0f / (1.0f + expf(-zr));
  }
  dv[BINS] = 1.0f;

  const float lo = -B + 1e-6f, hi = B - 1e-6f;
  const float xc = fminf(fmaxf(x, lo), hi);
  const int i = spline_bin(xc, kn[0]);
  float x0, x1, y0, y1, d0, d1;
  bin_edges(kn[0], i, &x0, &x1);
  bin_edges(kn[1], i, &y0, &y1);
  bin_edges(dv, i, &d0, &d1);
  const float w = x1 - x0;
  const float h = y1 - y0;
  const float s = h / w;
  const float xi = (xc - x0) / w;
  const float xi1m = 1.0f - xi;
  const float c = d1 + d0 - 2.0f * s;
  const float q = xi * xi1m;
  const float denom = s + c * q;
  const float num = s * xi * xi + d0 * q;
  const float n2 = d1 * xi * xi + 2.0f * s * q + d0 * xi1m * xi1m;

  // ladj = 2 log s + log n2 - 2 log denom; y = y0 + h * num / denom
  float g_s = 2.0f * gl / s;
  const float g_n2 = gl / n2;
  const float g_den = -2.0f * gl / denom - gy * h * num / (denom * denom);
  float g_y0 = gy;
  float g_h = gy * num / denom;
  const float g_num = gy * h / denom;
  float g_d1 = g_n2 * xi * xi;
  float g_xi = g_n2 * 2.0f * d1 * xi + g_num * 2.0f * s * xi;
  g_s = g_s + g_n2 * 2.0f * q + g_num * xi * xi + g_den;
  const float g_q = g_n2 * 2.0f * s + g_num * d0 + g_den * c;
  float g_d0 = g_n2 * xi1m * xi1m + g_num * q;
  float g_xi1m = g_n2 * 2.0f * d0 * xi1m;
  const float g_c = g_den * q;
  g_d1 = g_d1 + g_c;
  g_d0 = g_d0 + g_c;
  g_s = g_s - 2.0f * g_c;
  g_xi = g_xi + g_q * xi1m;
  g_xi1m = g_xi1m + g_q * xi;
  g_xi = g_xi - g_xi1m;
  const float g_xc = g_xi / w;
  float g_x0 = -g_xi / w;
  float g_w = -g_xi * xi / w;
  g_h = g_h + g_s / w;
  g_w = g_w - g_s * s / w;
  const float g_y1 = g_h;
  g_y0 = g_y0 - g_h;
  const float g_x1 = g_w;
  g_x0 = g_x0 - g_w;

  // knot j (1..BINS-1) is the running sum of bin sizes 0..j-1, so bin size
  // m collects the gradients of knots m+1..BINS-1; then the softmax
  const float g0[2] = {g_x0, g_y0}, g1[2] = {g_x1, g_y1};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float gsm[BINS];
    float dot = 0.0f;
#pragma unroll
    for (int m = 0; m < BINS; ++m) {
      const float gsize = (m < i ? g0[a] : 0.0f) + ((m <= i && i <= BINS - 2) ? g1[a] : 0.0f);
      gsm[m] = gsize * ((1.0f - MIN_BIN * BINS) * (2.0f * B));
      dot += sm[a][m] * gsm[m];
    }
#pragma unroll
    for (int m = 0; m < BINS; ++m) p[a * BINS + m] = sm[a][m] * (gsm[m] - dot);
  }
#pragma unroll
  for (int k = 1; k < BINS; ++k) {
    const float gd = (k == i ? g_d0 : 0.0f) + (k == i + 1 ? g_d1 : 0.0f);
    p[2 * BINS + k - 1] = gd * sig[k - 1];
  }
  return (x >= lo && x <= hi) ? g_xc : 0.0f;
}

// Vector-Jacobian product of the inverse for one element, at its data
// value x = rqs_inverse(z, p), the arithmetic of ops/flow_kernels.py
// inverse_element_vjp: given gx = dL/dx (every path to x) and gl =
// dL/dladj of the inverse's log-det -log(dy/dx), returns dL/dz = (gx -
// gl dlog(dy/dx)/dx) / (dy/dx) and overwrites p with dL/dp, minus the
// forward VJP's parameter gradient for (dL/dz, gl). Outside (-B, B) the
// inverse is the identity: dL/dz = gx, zero parameter gradients.
__device__ __forceinline__ float rqs_inverse_vjp(float x, float* p, float gx, float gl) {
  const float B = SPLINE_BOUND;
  if (!((x > -B) && (x < B))) {
#pragma unroll
    for (int i = 0; i < NPARAMS; ++i) p[i] = 0.0f;
    return gx;
  }
  const SplineVjp sp(x, p);
  const float gz = (gx - gl * sp.log_slope_dx()) / sp.slope();
  sp.vjp(gz, gl, p);
#pragma unroll
  for (int i = 0; i < NPARAMS; ++i) p[i] = -p[i];
  return gz;
}

// Reductions over the segments of the warp-wide layout, lane j holding
// raw parameter j: lanes 0..BINS-1 x's bins, BINS..2*BINS-1 y's (the lanes
// past them take y's segment's results, which they do not use). With BINS
// a power of two a segment is a group of xor-butterflies; otherwise every
// lane gathers its segment's lanes in order, the serial order of
// spline_knots. Every lane of a segment gets the same bits.
__device__ __forceinline__ int segment_base(int lane) { return lane < BINS ? 0 : BINS; }

__device__ __forceinline__ float segment_max(float v, int lane) {
  constexpr unsigned ALL = 0xffffffffu;
  if constexpr ((BINS & (BINS - 1)) == 0) {
#pragma unroll
    for (int o = BINS / 2; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(ALL, v, o));
    return v;
  } else {
    const int a = segment_base(lane);
    float m = __shfl_sync(ALL, v, a);
#pragma unroll
    for (int i = 1; i < BINS; ++i) m = fmaxf(m, __shfl_sync(ALL, v, a + i));
    return m;
  }
}

__device__ __forceinline__ float segment_sum(float v, int lane) {
  constexpr unsigned ALL = 0xffffffffu;
  if constexpr ((BINS & (BINS - 1)) == 0) {
#pragma unroll
    for (int o = BINS / 2; o >= 1; o >>= 1) v += __shfl_xor_sync(ALL, v, o);
    return v;
  } else {
    const int a = segment_base(lane);
    float s = __shfl_sync(ALL, v, a);
#pragma unroll
    for (int i = 1; i < BINS; ++i) s += __shfl_sync(ALL, v, a + i);
    return s;
  }
}

// inclusive scan over the segment, in bin order
__device__ __forceinline__ float segment_scan(float v, int lane) {
  constexpr unsigned ALL = 0xffffffffu;
  if constexpr ((BINS & (BINS - 1)) == 0) {
#pragma unroll
    for (int o = 1; o < BINS; o <<= 1) {
      const float u = __shfl_up_sync(ALL, v, o);
      if ((lane & (BINS - 1)) >= o) v += u;
    }
    return v;
  } else {
    const int a = segment_base(lane);
    float c = __shfl_sync(ALL, v, a);
#pragma unroll
    for (int i = 1; i < BINS; ++i) {
      const float u = __shfl_sync(ALL, v, a + i);
      if (i <= lane - a) c += u;
    }
    return c;
  }
}

// rqs_inverse_vjp of one row by the whole warp (WARP_SPLINE: up to 10
// bins): lane j < NPARAMS holds raw parameter j (0 in the other lanes),
// every lane x, gx and gl. The setup is split across lanes as K1's
// rqs_inverse_warp splits it (ar_inverse.cu): lanes 0..BINS-1 and
// BINS..2*BINS-1 the two softmaxes (segment_max and segment_sum) and the
// knots as an inclusive scan of the bin sizes, the next BINS-1 lanes the
// interior derivatives and their sigmoids; every lane gathers the knots and
// derivatives, then computes the bin, dL/dz and the bin's knot gradients;
// last, lane j's parameter gradient: a softmax's VJP over its segment (one
// more segment_sum for the dot product) or a derivative's. Returns dL/dz in
// every lane and writes lane j's dL/dp_j into *gp (0 from lane NPARAMS).
// The arithmetic of rqs_inverse_vjp but for the order of the sums.
__device__ __forceinline__ float rqs_inverse_vjp_warp(float x, float p, float gx, float gl,
                                                      int lane, float* gp) {
  constexpr unsigned ALL = 0xffffffffu;
  const float B = SPLINE_BOUND;
  if (!((x > -B) && (x < B))) {  // x is the same in every lane
    *gp = 0.0f;
    return gx;
  }
  const float m = segment_max(p, lane);
  const float e = expf(p - m);
  const float sum = segment_sum(e, lane);
  const float sm = e / sum;
  const float run = segment_scan((MIN_BIN + (1.0f - MIN_BIN * BINS) * sm) * (2.0f * B), lane);
  const float knot = run - B;
  const float zr = p + SOFTPLUS_INV_1;
  const float deriv = MIN_DERIV + softplusf(zr);
  const float sig = 1.0f / (1.0f + expf(-zr));
  float xk[BINS + 1], yk[BINS + 1], dv[BINS + 1];
  xk[0] = yk[0] = -B;
  xk[BINS] = yk[BINS] = B;
  dv[0] = dv[BINS] = 1.0f;
#pragma unroll
  for (int i = 1; i < BINS; ++i) {
    xk[i] = __shfl_sync(ALL, knot, i - 1);
    yk[i] = __shfl_sync(ALL, knot, BINS + i - 1);
    dv[i] = __shfl_sync(ALL, deriv, 2 * BINS + i - 1);
  }
  SplineVjp sp;
  sp.local(x, xk, yk, dv);
  const float gz = (gx - gl * sp.log_slope_dx()) / sp.slope();
  const SplineVjp::KnotGrads kg = sp.knot_grads(gz, gl);
  // bin size mm of softmax a (lanes 0..BINS-1: x, BINS..2*BINS-1: y)
  // collects the gradients of knots mm+1..BINS-1
  const bool a = lane >= BINS;
  const int mm = a ? lane - BINS : lane;
  const float g0 = a ? kg.y0 : kg.x0, g1 = a ? kg.y1 : kg.x1;
  const float gsize = (mm < sp.i ? g0 : 0.0f) + ((mm <= sp.i && sp.i <= BINS - 2) ? g1 : 0.0f);
  const float gsm = gsize * ((1.0f - MIN_BIN * BINS) * (2.0f * B));
  const float dot = segment_sum(sm * gsm, lane);
  // interior derivative k = lane - 2*BINS + 1 (lanes 2*BINS..NPARAMS-1)
  const int k = lane - 2 * BINS + 1;
  const float gd = (k == sp.i ? kg.d0 : 0.0f) + (k == sp.i + 1 ? kg.d1 : 0.0f);
  const float g = lane < 2 * BINS ? sm * (gsm - dot) : (lane < NPARAMS ? gd * sig : 0.0f);
  *gp = -g;
  return gz;
}

// A row's step as rqs_inverse_vjp_group takes it: lane m (0-7) of the
// row's group of 8 lanes holds bins m*SLICE_BINS.. m*SLICE_BINS +
// SLICE_BINS - 1 (one bin a lane up to 8 bins, two up to 16): their two
// raw sizes (-inf past the last bin, so that they weigh nothing in the
// softmaxes), the raw parameters of the interior derivatives of the same
// indices plus one (0 past the last), and the row's x. From the NPARAMS
// raw parameters then x, in global memory (K1's saved state).
struct RqsSlice {
  float px[SLICE_BINS], py[SLICE_BINS], pd[SLICE_BINS], x;
};

__device__ __forceinline__ RqsSlice rqs_slice(const float* p, int m) {
  RqsSlice q;
#pragma unroll
  for (int c = 0; c < SLICE_BINS; ++c) {
    const int b = m * SLICE_BINS + c;
    q.px[c] = b < BINS ? __ldg(p + b) : -INFINITY;
    q.py[c] = b < BINS ? __ldg(p + BINS + b) : -INFINITY;
    q.pd[c] = b < BINS - 1 ? __ldg(p + 2 * BINS + b) : 0.0f;
  }
  q.x = __ldg(p + NPARAMS);
  return q;
}

// rqs_inverse_vjp of one row by a group of 8 lanes (lane m of the group
// holds the row's slice), so one pass of a warp serves up to 4 rows. The
// setup is split across the group as K1's rqs_inverse_warp splits the
// inverse's: each lane takes its bins of both softmaxes (max and sum over
// its own, then xor-butterflies over the group, so every lane of the group
// gets the same bits) and of the knots (its bins' running sum after an
// inclusive scan of the lanes' totals) and its interior derivatives and
// sigmoids; every lane gathers the knots and derivatives, then computes
// the bin, dL/dz and the bin's knot gradients; last, lane m the gradients
// of its parameters (a softmax's VJP takes one more butterfly for the dot
// product). Returns dL/dz, given gx = dL/dx and gl = dL/dladj (the same in
// the group's lanes), and writes lane m's share of the row's dL/dp into gp
// (NPARAMS floats) unless it is null. The arithmetic of rqs_inverse_vjp
// but for the order of the sums; outside (-B, B) dL/dz = gx and dL/dp = 0.
__device__ __forceinline__ float rqs_inverse_vjp_group(const RqsSlice& q, float gx, float gl,
                                                       int m, float* gp) {
  constexpr unsigned ALL = 0xffffffffu;
  constexpr int G = 8;  // lanes a row
  constexpr int C = SLICE_BINS;
  const float B = SPLINE_BOUND;
  float mx = q.px[0], my = q.py[0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    mx = fmaxf(mx, q.px[c]);
    my = fmaxf(my, q.py[c]);
  }
#pragma unroll
  for (int o = G / 2; o >= 1; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(ALL, mx, o));
    my = fmaxf(my, __shfl_xor_sync(ALL, my, o));
  }
  float ex[C], ey[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ex[c] = expf(q.px[c] - mx);
    ey[c] = expf(q.py[c] - my);
  }
  float sx = ex[0], sy = ey[0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    sx += ex[c];
    sy += ey[c];
  }
#pragma unroll
  for (int o = G / 2; o >= 1; o >>= 1) {
    sx += __shfl_xor_sync(ALL, sx, o);
    sy += __shfl_xor_sync(ALL, sy, o);
  }
  // the lane's bins' sizes as a running sum, then the lanes' totals scanned
  float smx[C], smy[C], rx[C], ry[C];
  float runx = 0.0f, runy = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    smx[c] = ex[c] / sx;
    smy[c] = ey[c] / sy;
    const float ux = (MIN_BIN + (1.0f - MIN_BIN * BINS) * smx[c]) * (2.0f * B);
    const float uy = (MIN_BIN + (1.0f - MIN_BIN * BINS) * smy[c]) * (2.0f * B);
    runx = c == 0 ? ux : runx + ux;
    runy = c == 0 ? uy : runy + uy;
    rx[c] = runx;
    ry[c] = runy;
  }
  float tx = rx[C - 1], ty = ry[C - 1];
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const float vx = __shfl_up_sync(ALL, tx, o, G), vy = __shfl_up_sync(ALL, ty, o, G);
    if (m >= o) {
      tx += vx;
      ty += vy;
    }
  }
  float knot_x[C], knot_y[C];
  knot_x[C - 1] = tx - B;
  knot_y[C - 1] = ty - B;
  if constexpr (C > 1) {
    // the lanes before this one: the previous lane's inclusive total
    const float bx = __shfl_up_sync(ALL, tx, 1, G), by = __shfl_up_sync(ALL, ty, 1, G);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) {
      knot_x[c] = (m > 0 ? bx + rx[c] : rx[c]) - B;
      knot_y[c] = (m > 0 ? by + ry[c] : ry[c]) - B;
    }
  }
  float deriv[C], sig[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float zr = q.pd[c] + SOFTPLUS_INV_1;
    deriv[c] = MIN_DERIV + softplusf(zr);
    sig[c] = 1.0f / (1.0f + expf(-zr));
  }
  float xk[BINS + 1], yk[BINS + 1], dv[BINS + 1];
  xk[0] = yk[0] = -B;
  xk[BINS] = yk[BINS] = B;
  dv[0] = dv[BINS] = 1.0f;
#pragma unroll
  for (int i = 1; i < BINS; ++i) {
    const int src = (i - 1) / C, c = (i - 1) % C;
    xk[i] = __shfl_sync(ALL, knot_x[c], src, G);
    yk[i] = __shfl_sync(ALL, knot_y[c], src, G);
    dv[i] = __shfl_sync(ALL, deriv[c], src, G);
  }
  SplineVjp sp;
  sp.local(q.x, xk, yk, dv);
  const float gz = (gx - gl * sp.log_slope_dx()) / sp.slope();
  const SplineVjp::KnotGrads kg = sp.knot_grads(gz, gl);
  // bin size b collects the gradients of knots b+1..BINS-1, then each
  // softmax's VJP
  const float scale = (1.0f - MIN_BIN * BINS) * (2.0f * B);
  float gsx[C], gsy[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = m * C + c;
    const bool last = b <= sp.i && sp.i <= BINS - 2;
    gsx[c] = ((b < sp.i ? kg.x0 : 0.0f) + (last ? kg.x1 : 0.0f)) * scale;
    gsy[c] = ((b < sp.i ? kg.y0 : 0.0f) + (last ? kg.y1 : 0.0f)) * scale;
  }
  float dx = smx[0] * gsx[0], dy = smy[0] * gsy[0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    dx += smx[c] * gsx[c];
    dy += smy[c] * gsy[c];
  }
#pragma unroll
  for (int o = G / 2; o >= 1; o >>= 1) {
    dx += __shfl_xor_sync(ALL, dx, o);
    dy += __shfl_xor_sync(ALL, dy, o);
  }
  const bool inside = (q.x > -B) && (q.x < B);
  if (gp != nullptr) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int b = m * C + c;
      if (b < BINS) {
        gp[b] = inside ? -(smx[c] * (gsx[c] - dx)) : 0.0f;
        gp[BINS + b] = inside ? -(smy[c] * (gsy[c] - dy)) : 0.0f;
      }
      if (b < BINS - 1) {
        const int k = b + 1;  // interior derivative k
        const float gd = (k == sp.i ? kg.d0 : 0.0f) + (k == sp.i + 1 ? kg.d1 : 0.0f);
        gp[2 * BINS + b] = inside ? -(gd * sig[c]) : 0.0f;
      }
    }
  }
  return inside ? gz : gx;
}

// y -> x; *ladj = log|dx/dy|, from the spline's knots and derivatives
__device__ __forceinline__ float rqs_inverse_knots(float y, const float* xk, const float* yk,
                                                   const float* dv, float* ladj) {
  const float B = SPLINE_BOUND;
  const bool inside = (y > -B) && (y < B);
  const float yc = fminf(fmaxf(y, -B + 1e-6f), B - 1e-6f);
  const int i = spline_bin(yc, yk);
  float x0, x1, y0, y1, d0, d1;
  bin_edges(xk, i, &x0, &x1);
  bin_edges(yk, i, &y0, &y1);
  bin_edges(dv, i, &d0, &d1);
  float dydx;
  const float x = bin_inverse(yc - y0, x0, x1 - x0, y1 - y0, d0, d1, &dydx);
  *ladj = inside ? -logf(dydx) : 0.0f;
  return inside ? x : y;
}

// y -> x; *ladj = log|dx/dy|
__device__ __forceinline__ float rqs_inverse(float y, const float* p, float* ladj) {
  float xk[BINS + 1], yk[BINS + 1], dv[BINS + 1];
  spline_setup(p, xk, yk, dv);
  return rqs_inverse_knots(y, xk, yk, dv, ladj);
}
#endif  // !POCOMC_RUNTIME_BINS

// ---------------------------------------------------------------------------
// run-time bins (POCOMC_BINS=0): each function takes the bins and a view of
// the dimension's 3 bins - 1 raw parameters (ParamsAt, ParamsLdg) and
// streams over them: one pass for each softmax's max, one for its sum, then
// the running sums of bin sizes, k ascending, up to the bin that holds the
// position; the derivatives of that bin are read where needed. O(bins)
// work an element, in registers of a fixed count. The softmax's sum and
// the knots' running sums are compensated (Kahan): a plain serial sum's
// rounding grows with the bins, and at 1000 bins put the log-dets 0.016
// from float64, 30x the plain version's distance (its torch.cumsum and sum
// reduce in trees); compensated, they stay within the plain version's.
// ---------------------------------------------------------------------------
#if POCOMC_RUNTIME_BINS
// a softmax's max and sum, the sum in spline_knots' order
struct Softmax {
  float m, s;
};

// s += v with the running compensation c (Kahan)
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// the bin that holds pos: its lower knots x0, y0 with what their
// compensated sums had left over (the knot is x0 - cx0, y0 - cy0), its
// width and height (the sizes the running sums added, so no difference of
// knots rounds them) and its derivatives
struct Bin {
  int i;
  float x0, y0, cx0, cy0, w, h, d0, d1;
  // pos - x0 (by_y false) or pos - y0, the knot's leftover restored
  __device__ __forceinline__ float dx(float pos) const { return (pos - x0) + cx0; }
  __device__ __forceinline__ float dy(float pos) const { return (pos - y0) + cy0; }
};

template <class V>
__device__ __forceinline__ void softmax_stats(const V& p, int bins, Softmax* sx, Softmax* sy) {
  float mx = p[0], my = p[bins];
  for (int j = 1; j < bins; ++j) {
    mx = fmaxf(mx, p[j]);
    my = fmaxf(my, p[bins + j]);
  }
  float ex = 0.0f, ey = 0.0f, cx = 0.0f, cy = 0.0f;
  for (int j = 0; j < bins; ++j) {
    kahan_add(ex, cx, expf(p[j] - mx));
    kahan_add(ey, cy, expf(p[bins + j] - my));
  }
  *sx = {mx, ex};
  *sy = {my, ey};
}

// the softmax's value at raw parameter v
__device__ __forceinline__ float softmax_at(float v, const Softmax& a) {
  return expf(v - a.m) / a.s;
}

// The bin of pos among the x-knots (by_y false: the forward) or the
// y-knots (the inverse): the count of interior knots <= pos, which, the
// knots being running sums of positive sizes (non-decreasing, compensated
// or not), is the last knot <= pos, so the running sums stop at the first
// knot past it.
template <class V>
__device__ __forceinline__ Bin find_bin(const V& p, int bins, const Softmax& sx,
                                        const Softmax& sy, float pos, bool by_y) {
  const float B = SPLINE_BOUND;
  const float floor_scale = 1.0f - MIN_BIN * (float)bins;
  Bin b{0, -B, -B, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 1.0f};
  float cx = 0.0f, cy = 0.0f, ex = 0.0f, ey = 0.0f;
  bool last = true;
  for (int j = 1; j < bins; ++j) {
    const float vx = (MIN_BIN + floor_scale * softmax_at(p[j - 1], sx)) * (2.0f * B);
    const float vy = (MIN_BIN + floor_scale * softmax_at(p[bins + j - 1], sy)) * (2.0f * B);
    kahan_add(cx, ex, vx);
    kahan_add(cy, ey, vy);
    const float kx = cx - B, ky = cy - B;
    if ((by_y ? ky : kx) <= pos) {
      b = Bin{j, kx, ky, ex, ey, 0.0f, 0.0f, 1.0f, 1.0f};
    } else {
      b.w = vx;  // the size of bin j - 1 = b.i
      b.h = vy;
      last = false;
      break;
    }
  }
  if (last) {  // the last knot is B
    b.w = b.dx(B);
    b.h = b.dy(B);
  }
  if (b.i > 0) b.d0 = MIN_DERIV + softplusf(p[2 * bins + b.i - 1] + SOFTPLUS_INV_1);
  if (b.i < bins - 1) b.d1 = MIN_DERIV + softplusf(p[2 * bins + b.i] + SOFTPLUS_INV_1);
  return b;
}

// x -> y; *ladj = log|dy/dx|
template <class V>
__device__ __forceinline__ float rqs_forward_run(float x, const V& p, int bins, float* ladj) {
  const float B = SPLINE_BOUND;
  *ladj = 0.0f;
  if (!((x > -B) && (x < B))) return x;
  Softmax sx, sy;
  softmax_stats(p, bins, &sx, &sy);
  const float xc = fminf(fmaxf(x, -B + 1e-6f), B - 1e-6f);
  const Bin b = find_bin(p, bins, sx, sy, xc, false);
  float dydx;
  const float y = bin_forward(b.dx(xc), b.w, b.y0 - b.cy0, b.h, b.d0, b.d1, &dydx);
  *ladj = logf(dydx);
  return y;
}

// y -> x; *ladj = log|dx/dy|
template <class V>
__device__ __forceinline__ float rqs_inverse_run(float y, const V& p, int bins, float* ladj) {
  const float B = SPLINE_BOUND;
  *ladj = 0.0f;
  if (!((y > -B) && (y < B))) return y;
  Softmax sx, sy;
  softmax_stats(p, bins, &sx, &sy);
  const float yc = fminf(fmaxf(y, -B + 1e-6f), B - 1e-6f);
  const Bin b = find_bin(p, bins, sx, sy, yc, true);
  float dydx;
  const float x = bin_inverse(b.dy(yc), b.x0 - b.cx0, b.w, b.h, b.d0, b.d1, &dydx);
  *ladj = -logf(dydx);
  return x;
}

// The vector-Jacobian product of the forward (INVERSE false: rqs_forward_
// vjp's arithmetic, given g = dL/dy, returns dL/dx) or of the inverse at
// its data value x (INVERSE true: rqs_inverse_vjp's, given g = dL/dx,
// returns dL/dz), with gl = dL/dladj. Writes dL/dp (the inverse's: minus
// the forward VJP's parameter gradient for (dL/dz, gl)) into gp, which may
// be the view p reads: each raw size is read just before its gradient
// overwrites it, the two derivatives' sigmoids before any. Outside (-B, B)
// the map is the identity with zero parameter gradients.
template <bool INVERSE, class V, class G>
__device__ __forceinline__ float rqs_vjp_run(float x, const V& p, const G& gp, int bins, float g,
                                             float gl) {
  const float B = SPLINE_BOUND;
  if (!((x > -B) && (x < B))) {
    for (int j = 0; j < 3 * bins - 1; ++j) gp[j] = 0.0f;
    return g;
  }
  Softmax st[2];
  softmax_stats(p, bins, &st[0], &st[1]);
  const float xc = fminf(fmaxf(x, -B + 1e-6f), B - 1e-6f);
  const Bin b = find_bin(p, bins, st[0], st[1], xc, false);
  BinVjp v;
  v.set(x, b.dx(xc), b.w, b.h, b.d0, b.d1);
  const int i = b.i;
  const float gy = INVERSE ? (g - gl * v.log_slope_dx()) / v.slope() : g;
  const BinVjp::KnotGrads kg = v.knot_grads(gy, gl);
  // the interior derivatives i and i + 1 (raw parameters 2 bins + i - 1
  // and 2 bins + i), the only ones with a gradient
  const float sig0 = i >= 1 ? 1.0f / (1.0f + expf(-(p[2 * bins + i - 1] + SOFTPLUS_INV_1))) : 0.0f;
  const float sig1 = i + 1 <= bins - 1 ? 1.0f / (1.0f + expf(-(p[2 * bins + i] + SOFTPLUS_INV_1)))
                                       : 0.0f;
  // knot j (1..bins-1) is the running sum of bin sizes 0..j-1, so bin size
  // m collects the gradients of knots m+1..bins-1 (none past bin i); then
  // each softmax's VJP, its dot product over m <= i
  const float scale = (1.0f - MIN_BIN * (float)bins) * (2.0f * B);
  const float g0[2] = {kg.x0, kg.y0}, g1[2] = {kg.x1, kg.y1};
  const bool last = i <= bins - 2;
  float dot[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    dot[a] = 0.0f;
    for (int m = 0; m <= i; ++m) {
      const float gsize = (m < i ? g0[a] : 0.0f) + (last ? g1[a] : 0.0f);
      dot[a] += softmax_at(p[a * bins + m], st[a]) * (gsize * scale);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    for (int m = 0; m < bins; ++m) {
      const float gsize = (m < i ? g0[a] : 0.0f) + ((m <= i && last) ? g1[a] : 0.0f);
      const float r = softmax_at(p[a * bins + m], st[a]) * (gsize * scale - dot[a]);
      gp[a * bins + m] = INVERSE ? -r : r;
    }
  }
  for (int k = 1; k < bins; ++k) {
    const float r = k == i ? kg.d0 * sig0 : (k == i + 1 ? kg.d1 * sig1 : 0.0f);
    gp[2 * bins + k - 1] = INVERSE ? -r : r;
  }
  return INVERSE ? gy : (v.in_clamp ? kg.xc : 0.0f);
}
#endif  // POCOMC_RUNTIME_BINS

}  // namespace pocomc

// the spline's bins the library was compiled for, 0 where it takes them
// at run time (ops/_build.py checks it when it loads a library)
extern "C" int pocomc_spline_bins() {
#if POCOMC_RUNTIME_BINS
  return 0;
#else
  return pocomc::BINS;
#endif
}
