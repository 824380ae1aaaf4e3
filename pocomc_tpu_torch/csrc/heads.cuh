// The element transforms ("heads") the flow kernels are templated on: what
// turns a dimension's NP raw network outputs into a monotone map of that
// dimension. RqsHead is the 8-bin rational-quadratic spline of rqs.cuh
// (the nsf* and nsfc* flows), AffineHead the bounded-log-scale affine map
// of the maf* flows, term for term models/transforms.py affine_forward,
// affine_forward_vjp and affine_inverse; inverse_vjp is the inverse's
// element VJP (ops/flow_kernels.py inverse_element_vjp) in closed form.
// OG is the width of K1's output column group (ar_inverse.cu): NP rounded
// up to a group its products are instantiated for.
#pragma once

#include <math.h>

#include "rqs.cuh"

namespace pocomc {

struct RqsHead {
  static constexpr int NP = NPARAMS;
  static constexpr int OG = 24;
  __device__ __forceinline__ static float forward(float x, const float* p, float* ladj) {
    return rqs_forward(x, p, ladj);
  }
  __device__ __forceinline__ static float forward_vjp(float x, float* p, float gy, float gl) {
    return rqs_forward_vjp(x, p, gy, gl);
  }
  __device__ __forceinline__ static float inverse(float y, const float* p, float* ladj) {
    return rqs_inverse(y, p, ladj);
  }
  __device__ __forceinline__ static float inverse_vjp(float x, float* p, float gx, float gl) {
    return rqs_inverse_vjp(x, p, gx, gl);
  }
};

constexpr float LOG_SCALE_BOUND = 5.0f;

// p = [loc, raw]; s = B tanh(raw / B); z = (x - loc) e^-s, log|dz/dx| = -s
struct AffineHead {
  static constexpr int NP = 2;
  static constexpr int OG = 4;
  __device__ __forceinline__ static float forward(float x, const float* p, float* ladj) {
    const float s = LOG_SCALE_BOUND * tanhf(p[1] / LOG_SCALE_BOUND);
    *ladj = -s;
    return (x - p[0]) * expf(-s);
  }
  // overwrites p with dL/dloc, dL/draw and returns dL/dx, given gy = dL/dz
  // and gl = dL/dladj
  __device__ __forceinline__ static float forward_vjp(float x, float* p, float gy, float gl) {
    const float t = tanhf(p[1] / LOG_SCALE_BOUND);
    const float e = expf(-(LOG_SCALE_BOUND * t));
    const float z = (x - p[0]) * e;
    const float gx = gy * e;
    p[0] = -gx;
    p[1] = (-(gy * z) - gl) * (1.0f - t * t);
    return gx;
  }
  // z -> x = z e^s + loc, log|dx/dz| = s
  __device__ __forceinline__ static float inverse(float y, const float* p, float* ladj) {
    const float s = LOG_SCALE_BOUND * tanhf(p[1] / LOG_SCALE_BOUND);
    *ladj = s;
    return y * expf(s) + p[0];
  }
  // the inverse's VJP at its data value x, given gx = dL/dx and gl =
  // dL/dladj: returns dL/dz = gx e^s and overwrites p with dL/dloc = gx,
  // dL/draw = (gx (x - loc) + gl)(1 - t^2)
  __device__ __forceinline__ static float inverse_vjp(float x, float* p, float gx, float gl) {
    const float t = tanhf(p[1] / LOG_SCALE_BOUND);
    const float gz = gx * expf(LOG_SCALE_BOUND * t);
    p[1] = (gx * (x - p[0]) + gl) * (1.0f - t * t);
    p[0] = gx;
    return gz;
  }
};

}  // namespace pocomc
