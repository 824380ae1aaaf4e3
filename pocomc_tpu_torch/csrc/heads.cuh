// The element transforms ("heads") the flow kernels are templated on: what
// turns a dimension's NP raw network outputs into a monotone map of that
// dimension. RqsHead is the rational-quadratic spline of rqs.cuh, of the
// library's BINS bins (the nsf* and nsfc* flows), AffineHead the
// bounded-log-scale affine map
// of the maf* flows, term for term models/transforms.py affine_forward,
// affine_forward_vjp and affine_inverse; inverse_vjp is the inverse's
// element VJP (ops/flow_kernels.py inverse_element_vjp) in closed form;
// K1-bwd runs it for one row by a whole warp (inverse_vjp_warp, lane j
// holding raw parameter j, where NP + 1 values fit a warp: WARP) or by a
// group of 8 lanes (inverse_vjp_group, each lane holding its Slice of the
// row's step, read by slice from the NP raw parameters and x in global
// memory).
// OG is the width of K1's output column group (ar_inverse.cu): NP + 1
// rounded up to a multiple of 8 (24 at 8 bins, 48 at 16).
// In the library of run-time bins (rqs.cuh POCOMC_RUNTIME_BINS) RqsHead is
// the streaming spline of rqs.cuh's run-time section instead: RUNTIME set,
// NP 0 (a launch's np, 3 bins - 1, is the dimension's raw parameters), and
// each map takes a view of the parameters where the kernel keeps them and
// the bins; the kernels branch on RUNTIME where they size or address the
// parameters (K1 and K1-bwd then run the output layer in column groups of
// k1::GROUP, K5 and K2's backward a group in passes of an output pass).
#pragma once

#include <math.h>

#include "rqs.cuh"

namespace pocomc {

#if POCOMC_RUNTIME_BINS
struct RqsHead {
  static constexpr bool RUNTIME = true;
  static constexpr int NP = 0, OG = 0;  // a launch's np; head_floats(np)
  static constexpr bool WARP = false;
  template <class V>
  __device__ __forceinline__ static float forward(float x, const V& p, int bins, float* ladj) {
    return rqs_forward_run(x, p, bins, ladj);
  }
  template <class V>
  __device__ __forceinline__ static float inverse(float y, const V& p, int bins, float* ladj) {
    return rqs_inverse_run(y, p, bins, ladj);
  }
  // given gy = dL/dy and gl = dL/dladj, writes dL/dp into gp (which may be
  // p) and returns dL/dx
  template <class V, class G>
  __device__ __forceinline__ static float forward_vjp(float x, const V& p, const G& gp, int bins,
                                                      float gy, float gl) {
    return rqs_vjp_run<false>(x, p, gp, bins, gy, gl);
  }
  // the inverse's VJP at its data value x, given gx = dL/dx and gl:
  // returns dL/dz and writes dL/dp into gp (which may be p)
  template <class V, class G>
  __device__ __forceinline__ static float inverse_vjp(float x, const V& p, const G& gp, int bins,
                                                      float gx, float gl) {
    return rqs_vjp_run<true>(x, p, gp, bins, gx, gl);
  }
};
#else
struct RqsHead {
  static constexpr bool RUNTIME = false;
  static constexpr int NP = NPARAMS;
  static constexpr int OG = (NP + 1 + 7) / 8 * 8;
  static constexpr bool WARP = WARP_SPLINE;
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
  __device__ __forceinline__ static float inverse_vjp_warp(float x, float p, float gx, float gl,
                                                           int lane, float* gp) {
    return rqs_inverse_vjp_warp(x, p, gx, gl, lane, gp);
  }
  using Slice = RqsSlice;
  __device__ __forceinline__ static Slice slice(const float* p, int m) { return rqs_slice(p, m); }
  __device__ __forceinline__ static float inverse_vjp_group(const Slice& q, float gx, float gl,
                                                            int m, float* gp) {
    return rqs_inverse_vjp_group(q, gx, gl, m, gp);
  }
};
#endif

constexpr float LOG_SCALE_BOUND = 5.0f;

// p = [loc, raw]; s = B tanh(raw / B); z = (x - loc) e^-s, log|dz/dx| = -s
struct AffineHead {
  static constexpr bool RUNTIME = false;
  static constexpr int NP = 2;
  static constexpr int OG = 4;
  static constexpr bool WARP = true;
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
  // inverse_vjp with lane j < 2 holding p[j]: every lane computes it from
  // the two broadcast, lane j keeps dL/dp_j in *gp (0 from lane 2)
  __device__ __forceinline__ static float inverse_vjp_warp(float x, float p, float gx, float gl,
                                                           int lane, float* gp) {
    const float loc = __shfl_sync(0xffffffffu, p, 0), raw = __shfl_sync(0xffffffffu, p, 1);
    const float t = tanhf(raw / LOG_SCALE_BOUND);
    const float gz = gx * expf(LOG_SCALE_BOUND * t);
    *gp = lane == 0 ? gx : (lane == 1 ? (gx * (x - loc) + gl) * (1.0f - t * t) : 0.0f);
    return gz;
  }
  // inverse_vjp by every lane of a row's group, lane 0 writing dL/dp
  struct Slice {
    float loc, raw, x;
  };
  __device__ __forceinline__ static Slice slice(const float* p, int) {
    return {__ldg(p), __ldg(p + 1), __ldg(p + NP)};
  }
  __device__ __forceinline__ static float inverse_vjp_group(const Slice& q, float gx, float gl,
                                                            int m, float* gp) {
    const float t = tanhf(q.raw / LOG_SCALE_BOUND);
    const float gz = gx * expf(LOG_SCALE_BOUND * t);
    if (gp != nullptr && m == 0) {
      gp[1] = (gx * (q.x - q.loc) + gl) * (1.0f - t * t);
      gp[0] = gx;
    }
    return gz;
  }
};

// whether np names a head this library has: the spline of its bins (any
// 3 bins - 1 with bins >= 2 in the library of run-time bins), or (the
// default library only: POCOMC_AFFINE) the affine map
__host__ __forceinline__ bool head_compiled(int np) {
#if POCOMC_RUNTIME_BINS
  return np >= 5 && (np + 1) % 3 == 0;
#else
  return np == RqsHead::NP || (POCOMC_AFFINE && np == AffineHead::NP);
#endif
}

// floats of a K1 (and K1-bwd) row's head parameters with a head of np
// parameters: RqsHead::OG, AffineHead::OG, or the run-time spline's NP + 1
// rounded up to a multiple of 8 by the same rule
__host__ __device__ __forceinline__ int head_floats(int np) {
  return np == AffineHead::NP ? AffineHead::OG : (np + 1 + 7) / 8 * 8;
}

}  // namespace pocomc
