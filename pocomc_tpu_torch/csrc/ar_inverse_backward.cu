// K1-bwd: the vector-Jacobian product of K1 (ar_inverse.cu), the
// autoregressive inverse of a whole masked autoregressive transform stack,
// in its input: g_z = (dx/dz)^T g_x + (dladj/dz)^T g_ladj, from the data
// value x the inverse gave. The head (heads.cuh) is a template parameter.
//
// Replaces no Pallas kernel: the JAX package takes this gradient with
// jax.vjp through Flow.kernel_inv (pocomc_tpu/mcmc.py _grad_target, models/
// flow.py), XLA code, at every step of a preconditioned mala/hmc sweep.
//
// The inverse of a transform solves x one degree at a time, so its VJP is
// a triangular solve, walked here as K1's degree walk in reverse. The
// wrapper first runs K2's forward at x, which saves every transform's
// input and the three hidden activations relu(h0..h2) (the inverse's own
// intermediates up to rounding); then, transforms 0..T-1 (the inverse ran
// T-1..0), steps k = d-1..0 of each:
// 1. the head parameters of dimension j = inv_order[t, k] from relu(h2)'s
//    units of degree <= k (the pack's output group, summed as K1 sums it);
// 2. j's element VJP (heads.cuh inverse_vjp) at x_j with dL/dx_j = the
//    transform's g_x plus c_j, the cotangent the network sends to x_j from
//    the parameters of the dimensions of higher degree (complete now): it
//    gives dimension j's g_z and its parameters' cotangent;
// 3. that cotangent through the output group into relu(h2)'s units of
//    degree <= k;
// 4. the units of degree k are now final in every layer, top down: layer
//    2's dL/dh2 = ReLU' x its cotangent, then through W2's degree-k
//    columns into relu(h1)'s units of degree <= k; layer 1's dL/dh1 = the
//    residual dL/dh2 + ReLU' x its cotangent, through W1 into relu(h0);
//    layer 0's the same, through W0 into the x-cotangents of the inputs
//    visited before step k (degree <= k), which completes c at step k-1.
// Each hidden unit is pushed back once, the terms the masks zero skipped;
// the weights are exactly K1's pack, the groups read in reverse order.
//
// What bounds it on the H100: as K1, at small n the chain of T*d steps,
// each waiting for the step before (here also the element VJP of one row,
// one lane a row), at large n the masked multiply-adds, about twice K1's
// (the parameters again, then every weight once more for the push). The
// design keeps K1's:
// - Rows belong to warps: a consumer warp owns R rows for the whole
//   chain, their state in its slice of shared memory (the saved
//   activations and their cotangents degree-sorted, so the units of degree
//   <= k are a prefix, x and its cotangent in visit order, the cotangent
//   by dimension, the head parameters). Inside a step only __syncwarp and
//   shuffles.
// - A push gives each lane outputs (fan-in rows of the pack) and loops
//   over the group's columns: no reduction, one lane an output, so a
//   fixed order and no float atomics. Step 1's sum is K1's: lanes split
//   the fan-in, a butterfly of shuffles in one fixed order.
// - One producer warp streams the pack with bulk copies (TMA) into a ring
//   of S stages behind mbarrier pairs, one group to a stage (the planner
//   sizes a stage for the widest group whole), from the pack's end.
// fp32 with plain FMAs, no fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ar_walk.cuh"
#include "made_tile.cuh"  // heads.cuh, rqs.cuh, Saved and MAX_SMEM_BYTES

namespace {

using namespace pocomc;
using namespace pocomc::k1;

// The producer: every group of the pack, one bulk copy to a stage, from
// the pack's end backwards, in walk_back's order.
struct BackProducer {
  Ring ring;
  const float* pack;
  long long off;  // floats of the pack before the group after the next one
  int lane;

  __device__ __forceinline__ void transform_begin(int) {}
  __device__ __forceinline__ void group(int, int, int, int, int ncg, int, int fan) {
    const int floats = (int)group_floats(ncg, fan);
    off -= floats;
    float* dst = ring.fill_begin();
    uint64_t* bar = ring.full + ring.slot;
    if (lane == 0) {
      mbar_expect(bar, 4u * (uint32_t)floats);
      bulk_copy(dst, pack + off, 4u * (uint32_t)floats, bar);
    }
    __syncwarp();
    ring.advance();
  }
};

// The consumers of one block, each warp on its R rows. Row r's state
// starts at rows + r * RS: relu(h0), relu(h1), relu(h2) (h each,
// degree-sorted), then their cotangents G0, G1, G2 (h each; a unit's
// cotangent turns into dL/dh of its layer when it is final), x in visit
// order, its cotangent in visit order, the cotangent by dimension (d each:
// g_x of the transform in, g_z out), the head parameters (OG).
template <class Head, int R>
struct BackConsumer {
  Ring ring;
  Degrees g;
  const int* inv_order;
  Saved sv;
  float* rows;
  int RS, lane, row0, n;
  float gl;  // lane r < R: row r's dL/dladj

  __device__ __forceinline__ float* act(int l) const { return rows + l * g.h; }
  __device__ __forceinline__ float* cot(int l) const { return rows + (3 + l) * g.h; }
  __device__ __forceinline__ float* xv() const { return rows + 6 * g.h; }
  __device__ __forceinline__ float* cv() const { return rows + 6 * g.h + g.d; }
  __device__ __forceinline__ float* gd() const { return rows + 6 * g.h + 2 * g.d; }
  __device__ __forceinline__ float* par() const { return rows + 6 * g.h + 3 * g.d; }

  // transform t's saved input and activations of the warp's rows, the
  // cotangents zeroed, x's cotangent in visit order from the one by
  // dimension
  __device__ __forceinline__ void transform_begin(int t) {
    const int d = g.d, h = g.h;
    const int* order = inv_order + t * d;
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool real = row < n;
      const size_t base = ((size_t)t * n + (real ? row : 0));
      const int o = r * RS;
      for (int s = lane; s < h; s += 32) {
        const int u = g.unit(s);
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          act(l)[o + s] = real ? sv.a[l + 1][base * h + u] : 0.0f;
          cot(l)[o + s] = 0.0f;
        }
      }
      for (int k = lane; k < d; k += 32) {
        const int j = __ldg(order + k);
        xv()[o + k] = real ? sv.a[0][base * d + j] : 0.0f;
        cv()[o + k] = gd()[o + j];
      }
    }
    __syncwarp();
  }

  // the head parameters from relu(h2)'s units of degree <= k: lanes split
  // the fan-in, a butterfly reduce-scatter, the bias last (K1's product)
  __device__ __forceinline__ void params(const float* st, int fan, int fanp) {
    constexpr int G = Head::OG;
    const int ncg = Head::NP;
    float acc[R * G];
#pragma unroll
    for (int i = 0; i < R * G; ++i) acc[i] = 0.0f;
    const float* in = act(2);
    for (int i = lane; i < fan; i += 32) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = in[r * RS + i];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        if (jj < ncg) {
          const float w = st[jj * fanp + i];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r * G + jj] = fmaf(a[r], w, acc[r * G + jj]);
        }
      }
    }
    reduce_level<R * G, 0>(acc, lane);
    constexpr int H = halvings(R * G);
    constexpr int Q = (R * G) >> H;
    if ((lane & ((1 << (5 - H)) - 1)) == 0) {
      const int c = lane >> (5 - H);
#pragma unroll
      for (int m = 0; m < Q; ++m) {
        const int idx = c * Q + m;
        const int r = idx / G, jj = idx - r * G;
        if (jj < ncg) par()[r * RS + jj] = acc[m] + st[ncg * fanp + jj];
      }
    }
    __syncwarp();
  }

  // out[r][s] += sum over the group's columns jj of in[r][jj] * st[jj *
  // fanp + s], s < fan: lane s's outputs, jj ascending
  __device__ __forceinline__ void push(const float* st, const float* in, int ncg, int fan,
                                       int fanp, float* out) {
    for (int s = lane; s < fan; s += 32) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      for (int jj = 0; jj < ncg; ++jj) {
        const float w = st[jj * fanp + s];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(in[r * RS + jj], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) out[r * RS + s] += acc[r];
    }
    __syncwarp();
  }

  __device__ __forceinline__ void group(int t, int k, int l, int g0, int ncg, int, int fan) {
    const int fanp = round4(fan);
    const float* st = ring.acquire();
    __builtin_assume(__isShared(st));
    if (l == 3) {
      params(st, fan, fanp);
      if (lane < R) {
        float* row = rows + lane * RS;
        const int j = __ldg(inv_order + t * g.d + k);
        float p[Head::NP];
#pragma unroll
        for (int i = 0; i < Head::NP; ++i) p[i] = row[6 * g.h + 3 * g.d + i];
        row[6 * g.h + 2 * g.d + j] =
            Head::inverse_vjp(row[6 * g.h + k], p, row[6 * g.h + g.d + k], gl);
#pragma unroll
        for (int i = 0; i < Head::NP; ++i) row[6 * g.h + 3 * g.d + i] = p[i];
      }
      __syncwarp();
      push(st, par(), Head::NP, fan, fanp, cot(2));
    } else {
      // the group's units, degree k: their cotangent is final, so it turns
      // into dL/dh_l (ReLU' from the saved relu(h_l); the residual dL/dh_l+1
      // below the top layer), then goes through W_l's columns
      const int pos = g.count(k - 1) + g0;
      if (lane < ncg) {
        for (int r = 0; r < R; ++r) {
          const int at = r * RS + pos + lane;
          const float v = act(l)[at] > 0.0f ? cot(l)[at] : 0.0f;
          cot(l)[at] = l == 2 ? v : cot(l + 1)[at] + v;
        }
      }
      __syncwarp();
      push(st, cot(l) + pos, ncg, fan, fanp, l == 0 ? cv() : cot(l - 1));
    }
    ring.release();
  }
};

template <class Head, int R>
__global__ void __launch_bounds__(32 * (MAX_WARPS + 1))
    ar_inverse_backward_kernel(Saved sv, const float* __restrict__ gx,
                               const float* __restrict__ gladj, float* __restrict__ gz, int n,
                               int d, int h, int T, const float* __restrict__ pack,
                               long long pack_floats, const int* __restrict__ inv_order, int W,
                               int S, int SL) {
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
    BackProducer p{ring, pack, pack_floats, lane};
    walk_back<Head>(g, T, p);
    return;
  }

  const int RS = 6 * h + 3 * d + Head::OG;
  const int row0 = (blockIdx.x * W + warp) * R;
  BackConsumer<Head, R> c{ring, g, inv_order, sv, rows + warp * R * RS, RS, lane, row0, n, 0.0f};
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    for (int i = lane; i < d; i += 32)
      c.gd()[r * RS + i] = row < n ? gx[(size_t)row * d + i] : 0.0f;
  }
  if (lane < R) c.gl = row0 + lane < n ? gladj[row0 + lane] : 0.0f;
  __syncwarp();
  walk_back<Head>(g, T, c);
  __syncwarp();
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row < n)
      for (int i = lane; i < d; i += 32) gz[(size_t)row * d + i] = c.gd()[r * RS + i];
  }
}

template <class Head, int R>
int launch(const Saved& sv, const float* gx, const float* gladj, float* gz, int n, int d, int h,
           int T, const float* pack, long long pack_floats, const int* inv_order, int W, int S,
           int SL, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ar_inverse_backward_kernel<Head, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + R * W - 1) / (R * W);
  ar_inverse_backward_kernel<Head, R><<<blocks, 32 * (W + 1), smem, stream>>>(
      sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order, W, S, SL);
  return (int)cudaGetLastError();
}

template <class Head>
int launch_rows(int rows, const Saved& sv, const float* gx, const float* gladj, float* gz, int n,
                int d, int h, int T, const float* pack, long long pack_floats,
                const int* inv_order, int W, int S, int SL, size_t smem, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch<Head, 1>(sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order, W, S,
                             SL, smem, s);
    case 2:
      return launch<Head, 2>(sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order, W, S,
                             SL, smem, s);
    case 4:
      return launch<Head, 4>(sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order, W, S,
                             SL, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. a0 (T, n, d) and a1..a3 (T, n,
// h) are the inputs of every layer's product as K2's forward saved them at
// x, the inverse's output; gx (n, d) and gladj (n,) are dL/dx and
// dL/dladj; gz (n, d) receives dL/dz. pack and inv_order are K1's (the pack
// that ar_inverse_pack_launch wrote for the same weights, order and np).
// rows (1, 2 or 4) a consumer warp, warps (1-8) consumer warps a block,
// stages (2-8) of stage_floats floats, a multiple of 4 that holds the
// widest group of the pack (24 columns of h fan-in and their biases).
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int ar_inverse_backward_launch(const float* a0, const float* a1, const float* a2,
                                          const float* a3, const float* gx, const float* gladj,
                                          float* gz, int n, int d, int h, int T,
                                          const float* pack, const int* inv_order, int np,
                                          int rows, int warps, int stages, int stage_floats,
                                          int device, void* stream) {
  if (np != RqsHead::NP && np != AffineHead::NP) return (int)cudaErrorInvalidValue;
  const size_t row =
      6 * (size_t)h + 3 * (size_t)d + (np == AffineHead::NP ? AffineHead::OG : RqsHead::OG);
  const size_t smem = 16 * (size_t)stages +
                      sizeof(float) * ((size_t)stages * stage_floats + (size_t)warps * rows * row);
  if (n < 1 || d < 1 || h < 1 || T < 1 || warps < 1 || warps > MAX_WARPS || stages < 2 ||
      stages > MAX_STAGES || stage_floats % 4 != 0 ||
      stage_floats < group_floats(GROUP, h) || smem > (size_t)MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Degrees g(d, h);
  long long pack_floats = 0;
  for (int k = 0; k < d; ++k) pack_floats += step_floats(g, k, np);
  pack_floats *= T;
  const Saved sv{{const_cast<float*>(a0), const_cast<float*>(a1), const_cast<float*>(a2),
                  const_cast<float*>(a3)}};
  const cudaStream_t s = (cudaStream_t)stream;
  const int W = warps, S = stages, SL = stage_floats;
  if (np == AffineHead::NP)
    return launch_rows<AffineHead>(rows, sv, gx, gladj, gz, n, d, h, T, pack, pack_floats,
                                   inv_order, W, S, SL, smem, s);
  return launch_rows<RqsHead>(rows, sv, gx, gladj, gz, n, d, h, T, pack, pack_floats, inv_order,
                              W, S, SL, smem, s);
}
