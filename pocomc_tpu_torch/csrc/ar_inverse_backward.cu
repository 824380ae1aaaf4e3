// K1-bwd: the vector-Jacobian product of K1 (ar_inverse.cu), the
// autoregressive inverse of a whole masked autoregressive transform stack,
// in its input: g_z = (dx/dz)^T g_x + (dladj/dz)^T g_ladj, from the state a
// save instance of K1 wrote while it computed x. The head (heads.cuh) is a
// template parameter.
//
// Replaces no Pallas kernel: the JAX package takes this gradient with
// jax.vjp through Flow.kernel_inv (pocomc_tpu/mcmc.py _grad_target, models/
// flow.py), XLA code, at every step of a preconditioned mala/hmc sweep.
//
// The inverse of a transform solves x one degree at a time, so its VJP is
// a triangular solve, walked here as K1's degree walk in reverse. K1 saved
// (SavedState, ar_walk.cuh) each step's head parameters and x and each
// transform's hidden signs; then, transforms 0..T-1 (the inverse ran
// T-1..0), steps k = d-1..0 of each:
// 1. dimension j = inv_order[t, k]'s element VJP (heads.cuh
//    inverse_vjp_group) at its saved x and parameters, with dL/dx_j = the
//    transform's g_x plus c_j, the cotangent the network sends to x_j from
//    the parameters of the dimensions of higher degree (complete now): it
//    gives dimension j's g_z and its parameters' cotangent;
// 2. that cotangent through the output group into relu(h2)'s units of
//    degree <= k;
// 3. the units of degree k are now final in every layer, top down: layer
//    2's dL/dh2 = ReLU' x its cotangent, then through W2's degree-k
//    columns into relu(h1)'s units of degree <= k; layer 1's dL/dh1 = the
//    residual dL/dh2 + ReLU' x its cotangent, through W1 into relu(h0);
//    layer 0's the same, through W0 into the x-cotangents of the inputs
//    visited before step k (degree <= k), which completes c at step k-1.
// Each hidden unit is pushed back once, the terms the masks zero skipped;
// the weights are exactly K1's pack, the groups read in reverse order.
//
// What bounds it on the H100: as K1, at small n the chain of T*d steps,
// each waiting for the step before, at large n the masked multiply-adds
// (K1's, once each: the head parameters are K1's own, not recomputed).
// The design:
// - Rows belong to warps: a consumer warp owns R rows for the whole chain,
//   their state in its slice of shared memory: the three layers'
//   cotangents, degree-sorted so that the units of degree <= k are a
//   prefix, the hidden signs as bit masks, x's cotangent in visit order and
//   by dimension, the parameters' cotangent; 3h + 3 ceil(h/32) + 2d + OG
//   floats a row, 123 KB at h = 8192, d = 2730. Inside a step only
//   __syncwarp and shuffles.
// - The element VJP runs warp-wide in one-row warps (heads.cuh
//   inverse_vjp_warp: the spline's setup split across the lanes as K1's
//   rqs_inverse_warp splits the inverse's, a parameter a lane; up to 10
//   bins, where the NP + 1 values fit a warp), and on a group of 8 lanes a
//   row in warps of 2 or 4 rows and in one-row warps past 10 bins
//   (inverse_vjp_group: ceil(BINS/8) bins of each softmax and as many
//   derivatives a lane), so that one pass serves
//   all of a warp's rows (each row warp-wide in turn, or one lane a row,
//   measured slower there; 8 lanes a row slower in one-row warps: PERF.md).
//   The step's saved parameters and x are read from global memory one step
//   ahead into registers, so the load is off the chain.
// - A push gives each lane outputs (fan-in rows of the pack) and loops over
//   the group's columns: no reduction, one lane an output, so a fixed order
//   and no float atomics. The group's inputs (its columns' cotangents, R x
//   up to 24) are read into registers once; then each FMA costs one LDS of
//   its weight.
// - One producer warp streams the pack with bulk copies (TMA) into a ring
//   of S stages behind mbarrier pairs, from the pack's end. For one-row
//   warps consecutive whole groups of the reverse walk, a contiguous range
//   of the pack, go as one copy that lands at the stage's end (Ring::
//   take_back), so a step at small d costs no wait of its own; a group too
//   large for a stage goes in fan-in chunks (each push only adds its
//   chunk's outputs), so every (d, h) that K1 runs, to d = 2730, fits.
// fp32 with plain FMAs, no fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ar_walk.cuh"
#include "made_tile.cuh"  // heads.cuh, rqs.cuh and MAX_SMEM_BYTES

namespace {

using namespace pocomc;
using namespace pocomc::k1;

// The producer: every group of the pack from its end backwards, in
// walk_back's order. A group whose padded fan-in fits a stage is one bulk
// copy that lands at the stage's end; with `batch` (one-row warps)
// consecutive such groups go together, as many as fit a stage, landing at
// its end in pack order. A group whose
// padded fan-in does not fit goes in pieces of chunk_rows rows, each a
// bulk copy a column and one of the biases, as K1's producer cuts them.
struct BackProducer {
  Ring ring;
  const float* pack;
  long long off;  // floats of the pack before the groups sent or gathered
  int lane;
  bool batch;

  // send the whole groups gathered so far: pack [off, off + used)
  __device__ __forceinline__ void flush() {
    if (ring.used == 0) return;
    float* dst = ring.fill_begin() + ring.SL - ring.used;
    uint64_t* bar = ring.full + ring.slot;
    if (lane == 0) {
      mbar_expect(bar, 4u * (uint32_t)ring.used);
      bulk_copy(dst, pack + off, 4u * (uint32_t)ring.used, bar);
    }
    __syncwarp();
    ring.advance();
    ring.used = 0;
  }
  __device__ __forceinline__ void transform_begin(int) {}
  __device__ __forceinline__ void group(int, int, int, int, int ncg, int, int fan) {
    const int fanp = round4(fan), nb = round4(ncg);
    const int ch = chunk_rows(ring.SL, ncg);
    const int floats = (int)group_floats(ncg, fan);
    if (fanp <= ch) {
      if (ring.used + floats > ring.SL) flush();
      off -= floats;
      ring.used += floats;
      if (!batch) flush();
      return;
    }
    flush();
    off -= floats;
    const float* blk = pack + off;
    int i0 = 0;
    do {
      const int nf = min(ch, fan - i0), nfp = round4(nf);
      float* dst = ring.fill_begin();
      uint64_t* bar = ring.full + ring.slot;
      if (lane == 0) mbar_expect(bar, 4u * (uint32_t)(ncg * nfp + nb));
      __syncwarp();
      // column c by lane c mod 32 (a spline head's output group passes 32
      // columns from 11 bins), then the biases
      for (int c = lane; c <= ncg; c += 32) {
        if (c < ncg) bulk_copy(dst + c * nfp, blk + c * fanp + i0, 4u * nfp, bar);
        else bulk_copy(dst + ncg * nfp, blk + ncg * fanp, 4u * nb, bar);
      }
      ring.advance();
      i0 += nf;
    } while (i0 < fan);
  }
};

// a head's Slice, none for the spline of run-time bins
template <class Head, bool = Head::RUNTIME>
struct SliceOf {
  using type = typename Head::Slice;
};
template <class Head>
struct SliceOf<Head, true> {
  struct type {};
};

// The consumers of one block, each warp on its R rows. Row r's state
// starts at rows + r * RS: the cotangents of relu(h0), relu(h1), relu(h2)
// (h each, degree-sorted; a unit's turns into dL/dh of its layer when it
// is final), the three layers' sign masks (HW words each), x's cotangent in
// visit order and by dimension (d each: g_x of the transform in, g_z out),
// the head parameters' cotangent (OG).
template <class Head, int R>
struct BackConsumer {
  Ring ring;
  Degrees g;
  const int* inv_order;
  SavedState sv;
  float* rows;
  int RS, HW, lane, row0, n;
  int np;       // the head's raw parameters
  float gl[R];  // each row's dL/dladj
  // the element VJP warp-wide (one-row warps, where NP + 1 values fit a
  // warp) or 8 lanes a row (PERF.md)
  static constexpr bool WARP = R == 1 && Head::WARP;
  float pre[R];  // WARP: lane j <= NP holds value j of each row's next step
  // else (but with the spline of run-time bins, which streams the saved
  // state from global memory): the lane's share of its row's next step
  typename SliceOf<Head>::type nxt;

  __device__ __forceinline__ float* cot(int l) const { return rows + l * g.h; }
  __device__ __forceinline__ const unsigned* sgn(int l) const {
    return reinterpret_cast<const unsigned*>(rows + 3 * g.h) + l * HW;
  }
  __device__ __forceinline__ float* cv() const { return rows + 3 * g.h + 3 * HW; }
  __device__ __forceinline__ float* gd() const { return cv() + g.d; }
  __device__ __forceinline__ float* par() const { return gd() + g.d; }

  // the saved parameters and x of step k of transform t: a lane a value,
  // or the lane's share of its row (lanes 8r..8r+7: row r)
  __device__ __forceinline__ const float* saved(int t, int k, int row) const {
    return sv.px + (((size_t)t * n + row) * g.d + k) * ((Head::RUNTIME ? np : Head::NP) + 1);
  }
  __device__ __forceinline__ void load(int t, int k) {
    if constexpr (Head::RUNTIME) {
      return;
    } else if constexpr (WARP) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        pre[r] = row0 + r < n && lane <= Head::NP ? __ldg(saved(t, k, row0 + r) + lane) : 0.0f;
    } else {
      const int r = lane >> 3, row = row0 + r;
      nxt = r < R && row < n ? Head::slice(saved(t, k, row), lane & 7) : typename Head::Slice{};
    }
  }

  // transform t's sign masks, the cotangents zeroed, x's cotangent in
  // visit order from the one by dimension; the last step's saved values
  __device__ __forceinline__ void transform_begin(int t) {
    const int d = g.d, h = g.h;
    const int* order = inv_order + t * d;
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const int o = r * RS;
      unsigned* masks = reinterpret_cast<unsigned*>(rows + o + 3 * h);
      const unsigned* saved = sv.signs + ((size_t)t * n + row) * 3 * HW;
      for (int w = lane; w < 3 * HW; w += 32) masks[w] = row < n ? __ldg(saved + w) : 0u;
      for (int s = lane; s < 3 * h; s += 32) rows[o + s] = 0.0f;
      for (int k = lane; k < d; k += 32) cv()[o + k] = gd()[o + __ldg(order + k)];
    }
    load(t, d - 1);
    __syncwarp();
  }

  // out[r][s] += sum over the group's columns jj of v[r][jj] * st[jj *
  // nfp + s], s < nf: lane s's outputs, jj ascending
  template <int G>
  __device__ __forceinline__ void push_rows(const float* st, const float (&v)[R * G], int ncg,
                                            int nf, int nfp, float* out) {
    __builtin_assume(__isShared(st));
    for (int s = lane; s < nf; s += 32) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        if (jj < ncg) {
          const float w = st[jj * nfp + s];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r * G + jj], w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) out[r * RS + s] += acc[r];
    }
  }

  // one group of ncg <= G columns and fan fan-in rows: its inputs in[r][jj]
  // into registers, then every piece of it, out[r][s] += its products
  template <int G>
  __device__ __forceinline__ void push(const float* in, int ncg, int fan, float* out) {
    float v[R * G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int jj = 0; jj < G; ++jj) v[r * G + jj] = jj < ncg ? in[r * RS + jj] : 0.0f;
    const int ch = chunk_rows(ring.SL, ncg);
    if (round4(fan) <= ch) {
      // a whole group, at the end of its stage; one-row warps share stages
      // among whole groups (BackProducer::batch)
      const int floats = (int)group_floats(ncg, fan);
      if (R == 1) {
        push_rows<G>(ring.take_back(floats), v, ncg, fan, round4(fan), out);
      } else {
        push_rows<G>(ring.acquire() + ring.SL - floats, v, ncg, fan, round4(fan), out);
        ring.release();
      }
    } else {
      for (int i0 = 0; i0 < fan; i0 += ch) {
        const int nf = min(ch, fan - i0);
        push_rows<G>(ring.acquire(), v, ncg, nf, round4(nf), out + i0);
        ring.release();
      }
    }
    __syncwarp();
  }

  // dimension inv_order[t, k]'s element VJP of every row (warp-wide in
  // turn, or row r on lanes 8r..8r+7, or, with the spline of run-time bins,
  // on lane r, streaming the saved parameters from global memory): its g_z
  // into gd, its parameters' cotangent into par
  __device__ __forceinline__ void element(int t, int k) {
    const int j = __ldg(inv_order + t * g.d + k);
    if constexpr (Head::RUNTIME) {
      if (lane < R) {
        const int r = lane, row = row0 + r;
        float* gp = par() + r * RS;
        if (row < n) {
          const float* p = saved(t, k, row);
          gd()[r * RS + j] = Head::inverse_vjp(__ldg(p + np), ParamsLdg{p}, ParamsAt<1>{gp},
                                               (np + 1) / 3, cv()[r * RS + k], gl[r]);
        } else {
          for (int i = 0; i < np; ++i) gp[i] = 0.0f;
          gd()[r * RS + j] = 0.0f;
        }
      }
    } else if constexpr (WARP) {
      float gz[R], gp[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = __shfl_sync(FULL_MASK, pre[r], Head::NP);
        gz[r] = Head::inverse_vjp_warp(x, lane < Head::NP ? pre[r] : 0.0f, cv()[r * RS + k],
                                       gl[r], lane, &gp[r]);
      }
      if (k >= 1) load(t, k - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane < Head::NP) par()[r * RS + lane] = gp[r];
        if (lane == 0) gd()[r * RS + j] = gz[r];
      }
    } else {
      const int r = lane >> 3;
      const bool mine = r < R;
      float glr = gl[0];
#pragma unroll
      for (int i = 1; i < R; ++i)
        if (r == i) glr = gl[i];
      const float gz = Head::inverse_vjp_group(nxt, mine ? cv()[r * RS + k] : 0.0f, glr,
                                               lane & 7, mine ? par() + r * RS : nullptr);
      if (k >= 1) load(t, k - 1);
      if (mine && (lane & 7) == 0) gd()[r * RS + j] = gz;
    }
    __syncwarp();
  }

  __device__ __forceinline__ void group(int t, int k, int l, int g0, int ncg, int gw, int fan) {
    if (l == 3) {
      if constexpr (Head::RUNTIME) {
        // the step's first output group in this walk is its last: the
        // element VJP once, then each group of GROUP columns
        if (g0 + ncg == np) element(t, k);
        push<GROUP>(par() + g0, ncg, fan, cot(2));
      } else {
        element(t, k);
        push<Head::OG>(par(), Head::NP, fan, cot(2));
      }
      return;
    }
    // the group's units, degree k: their cotangent is final, so it turns
    // into dL/dh_l (ReLU' from the saved sign; the residual dL/dh_l+1 below
    // the top layer), then goes through W_l's columns
    const int pos = g.count(k - 1) + g0;
    if (lane < ncg) {
      const int s = pos + lane;
      for (int r = 0; r < R; ++r) {
        const int at = r * RS + s;
        const bool on = (sgn(l)[r * RS + (s >> 5)] >> (s & 31)) & 1u;
        const float v = on ? cot(l)[at] : 0.0f;
        cot(l)[at] = l == 2 ? v : cot(l + 1)[at] + v;
      }
    }
    __syncwarp();
    float* in = cot(l) + pos;
    float* out = l == 0 ? cv() : cot(l - 1);
    if (gw == 4) push<4>(in, ncg, fan, out);
    else if (gw == 8) push<8>(in, ncg, fan, out);
    else push<GROUP>(in, ncg, fan, out);
  }
};

template <class Head, int R>
__global__ void __launch_bounds__(32 * (MAX_WARPS + 1))
    ar_inverse_backward_kernel(SavedState sv, const float* __restrict__ gx,
                               const float* __restrict__ gladj, float* __restrict__ gz, int n,
                               int d, int h, int T, const float* __restrict__ pack,
                               long long pack_floats, const int* __restrict__ inv_order, int np,
                               int W, int S, int SL) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  float* stage = reinterpret_cast<float*>(smem + 16 * S);
  float* rows = stage + S * SL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, W);
    }
  }
  __syncthreads();
  const Degrees g(d, h);
  const Ring ring{stage, full, empty, S, SL, 0, 0u, false, false, 0};

  if (warp == W) {
    BackProducer p{ring, pack, pack_floats, lane, R == 1};
    walk_back<Head>(g, T, np, p);
    p.flush();
    return;
  }

  const int HW = sign_words(h);
  const int RS = 3 * h + 3 * HW + 2 * d + (Head::RUNTIME ? head_floats(np) : Head::OG);
  const int row0 = (blockIdx.x * W + warp) * R;
  BackConsumer<Head, R> c{ring, g, inv_order, sv, rows + warp * R * RS, RS, HW, lane, row0, n,
                          Head::RUNTIME ? np : Head::NP};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    for (int i = lane; i < d; i += 32)
      c.gd()[r * RS + i] = row < n ? gx[(size_t)row * d + i] : 0.0f;
    c.gl[r] = row < n ? gladj[row] : 0.0f;
  }
  __syncwarp();
  walk_back<Head>(g, T, np, c);
  __syncwarp();
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row < n)
      for (int i = lane; i < d; i += 32) gz[(size_t)row * d + i] = c.gd()[r * RS + i];
  }
}

template <class Head, int R>
int launch(const SavedState& sv, const float* gx, const float* gladj, float* gz, int n, int d,
           int h, int T, const float* pack, long long pack_floats, const int* inv_order, int np,
           int W, int S, int SL, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ar_inverse_backward_kernel<Head, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + R * W - 1) / (R * W);
  ar_inverse_backward_kernel<Head, R><<<blocks, 32 * (W + 1), smem, stream>>>(
      sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order, np, W, S, SL);
  return (int)cudaGetLastError();
}

template <class Head>
int launch_rows(int rows, const SavedState& sv, const float* gx, const float* gladj, float* gz,
                int n, int d, int h, int T, const float* pack, long long pack_floats,
                const int* inv_order, int np, int W, int S, int SL, size_t smem,
                cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch<Head, 1>(sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order, np, W,
                             S, SL, smem, s);
    case 2:
      return launch<Head, 2>(sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order, np, W,
                             S, SL, smem, s);
    case 4:
      return launch<Head, 4>(sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order, np, W,
                             S, SL, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One element's inverse VJP a row, by one of the kernel's versions (LANES
// 32: a warp a row, inverse_vjp_warp, where the head has WARP; 8: a group
// of 8 lanes a row,
// inverse_vjp_group) or by the one-lane one (LANES 1: heads.cuh
// inverse_vjp), for the tests: px (n, NP + 1: the raw parameters, then x),
// gx, gl (n,) -> gz (n,), gp (n, NP).
template <class Head, int LANES>
__global__ void element_vjp_kernel(const float* __restrict__ px, const float* __restrict__ gx,
                                   const float* __restrict__ gl, float* __restrict__ gz,
                                   float* __restrict__ gp, int n) {
  constexpr int NP = Head::NP;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (LANES == 32) {
    const int row = t >> 5, lane = t & 31;
    if (row >= n) return;  // the whole warp
    const float v = lane <= NP ? px[(size_t)row * (NP + 1) + lane] : 0.0f;
    float g;
    const float z = Head::inverse_vjp_warp(__shfl_sync(0xffffffffu, v, NP), lane < NP ? v : 0.0f,
                                           gx[row], gl[row], lane, &g);
    if (lane < NP) gp[(size_t)row * NP + lane] = g;
    if (lane == 0) gz[row] = z;
  } else if constexpr (LANES == 8) {
    const int row = t >> 3, m = t & 7;
    const bool real = row < n;  // every lane takes part in the shuffles
    const typename Head::Slice q =
        real ? Head::slice(px + (size_t)row * (NP + 1), m) : typename Head::Slice{};
    const float z = Head::inverse_vjp_group(q, real ? gx[row] : 0.0f, real ? gl[row] : 0.0f, m,
                                            real ? gp + (size_t)row * NP : nullptr);
    if (real && m == 0) gz[row] = z;
  } else if (t < n) {
    float q[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) q[i] = px[(size_t)t * (NP + 1) + i];
    gz[t] = Head::inverse_vjp(px[(size_t)t * (NP + 1) + NP], q, gx[t], gl[t]);
#pragma unroll
    for (int i = 0; i < NP; ++i) gp[(size_t)t * NP + i] = q[i];
  }
}

// the same with the spline of run-time bins (np raw parameters), one lane
// a row, the kernel's own element VJP
template <class Head>
__global__ void element_vjp_run_kernel(const float* __restrict__ px, const float* __restrict__ gx,
                                       const float* __restrict__ gl, float* __restrict__ gz,
                                       float* __restrict__ gp, int n, int np) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float* p = px + (size_t)t * (np + 1);
  gz[t] = Head::inverse_vjp(__ldg(p + np), ParamsLdg{p}, ParamsAt<1>{gp + (size_t)t * np},
                            (np + 1) / 3, gx[t], gl[t]);
}

template <class Head>
int launch_element(const float* px, const float* gx, const float* gl, float* gz, float* gp, int n,
                   int np, int lanes, cudaStream_t s) {
  const int blocks = ((long long)lanes * n + 127) / 128;
  if constexpr (Head::RUNTIME) {
    if (lanes != 1) return (int)cudaErrorInvalidValue;
    element_vjp_run_kernel<Head><<<blocks, 128, 0, s>>>(px, gx, gl, gz, gp, n, np);
  } else {
    if (lanes == 32 && Head::WARP)
      element_vjp_kernel<Head, 32><<<blocks, 128, 0, s>>>(px, gx, gl, gz, gp, n);
    else if (lanes == 8)
      element_vjp_kernel<Head, 8><<<blocks, 128, 0, s>>>(px, gx, gl, gz, gp, n);
    else if (lanes == 1)
      element_vjp_kernel<Head, 1><<<blocks, 128, 0, s>>>(px, gx, gl, gz, gp, n);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The element VJP of n rows (element_vjp_kernel) on `lanes` lanes a row (32,
// 8 or 1; 1 only with the spline of run-time bins): px (n, np + 1), gx, gl,
// gz (n,), gp (n, np). Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int ar_inverse_element_vjp_launch(const float* px, const float* gx, const float* gl,
                                             float* gz, float* gp, int n, int np, int lanes,
                                             int device, void* stream) {
  if (n < 1 || !head_compiled(np)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
#if POCOMC_AFFINE
  if (np == AffineHead::NP)
    return launch_element<AffineHead>(px, gx, gl, gz, gp, n, np, lanes, s);
#endif
  return launch_element<RqsHead>(px, gx, gl, gz, gp, n, np, lanes, s);
}

// Plain C entry point, loaded with ctypes. px (T, n, d, np + 1) and signs
// (T, n, 3, ceil(h / 32)) are the state K1's save instance wrote
// (ar_inverse_launch with save_px and save_signs) while it inverted the n
// rows; gx (n, d) and gladj (n,) are dL/dx and dL/dladj of that inverse;
// gz (n, d) receives dL/dz. pack and inv_order are K1's (the pack that
// ar_inverse_pack_launch wrote for the same weights, order and np). rows
// (1, 2 or 4) a consumer warp, warps (1-8) consumer warps a block, stages
// (2-8) of stage_floats floats, a multiple of 4, at least 5 times K1's
// widest group (a group too large for a stage goes in fan-in chunks).
// Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// does not take.
extern "C" int ar_inverse_backward_launch(const float* px, const unsigned* signs,
                                          const float* gx, const float* gladj, float* gz, int n,
                                          int d, int h, int T, const float* pack,
                                          const int* inv_order, int np, int rows, int warps,
                                          int stages, int stage_floats, int device,
                                          void* stream) {
  if (!head_compiled(np)) return (int)cudaErrorInvalidValue;
  const int og = head_floats(np), widest = RUNTIME_BINS || og < GROUP ? GROUP : og;
  const size_t row = 3 * (size_t)h + 3 * (size_t)sign_words(h) + 2 * (size_t)d + og;
  const size_t smem = 16 * (size_t)stages +
                      sizeof(float) * ((size_t)stages * stage_floats + (size_t)warps * rows * row);
  if (n < 1 || d < 1 || h < 1 || T < 1 || warps < 1 || warps > MAX_WARPS || stages < 2 ||
      stages > MAX_STAGES || stage_floats % 4 != 0 || stage_floats < 5 * widest ||
      smem > (size_t)MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Degrees g(d, h);
  long long pack_floats = 0;
  for (int k = 0; k < d; ++k) pack_floats += step_floats(g, k, np);
  pack_floats *= T;
  const SavedState sv{const_cast<float*>(px), const_cast<unsigned*>(signs)};
  const cudaStream_t s = (cudaStream_t)stream;
  const int W = warps, S = stages, SL = stage_floats;
#if POCOMC_AFFINE
  if (np == AffineHead::NP)
    return launch_rows<AffineHead>(rows, sv, gx, gladj, gz, n, d, h, T, pack, pack_floats,
                                   inv_order, np, W, S, SL, smem, s);
#endif
  return launch_rows<RqsHead>(rows, sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order,
                              np, W, S, SL, smem, s);
}
