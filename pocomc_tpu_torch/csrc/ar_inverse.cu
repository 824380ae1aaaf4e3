// K1: autoregressive inverse of a whole masked autoregressive transform
// stack, latent -> data, with the summed log|det dx/dz|. The element
// transform is the head (heads.cuh), a template parameter: the spline of
// the nsf* flows (BINS bins, one library a bins: rqs.cuh) or the affine map
// of the maf* flows.
//
// Replaces the round-2 Pallas kernel of the JAX package, a fused
// whole-transform autoregressive inverse with the masked weights resident
// and all d steps unrolled (never committed; specified in RESULTS.md
// "Pallas postmortem" and pocomc_tpu/models/flow.py:170-184). Its live XLA
// counterpart is flow.py transform_inverse / the reverse scan over
// transforms, made.py apply_made_dim and transforms.py rqs_inverse.
//
// Precondition: the weights are already multiplied by the masks of
// models/made.py make_masks for (d, h). Then each hidden unit is computed
// once, at the step where it becomes final. Input dimension inv_order[t, k]
// has degree k + 1; hidden unit u has degree u mod D + 1 (D = max(1, d-1));
// hidden layers connect where degree >= degree, the output where degree >
// degree. So step k of transform t computes the layer-0, then layer-1, then
// layer-2 units of degree k (fan-in: the inputs, or the units below, of
// degree <= k), then the NP head parameters of dimension inv_order[t, k]
// from the layer-2 units of degree <= k (3 BINS - 1 for the spline, 2 for
// the affine map), then that dimension's inverse. Masked-out terms are
// skipped, not multiplied by zero; with unmasked weights the result is not
// the plain version's.
//
// What bounds it on the H100: at small n the dependency chain of T*d steps
// (each waits for the previous dimension's spline), at large n the
// multiply-adds the masks leave (5.2 k a row and transform at d=10, h=32;
// 225 k at d=50, h=256). The design:
// - Rows belong to warps. A consumer warp owns R rows for the whole chain
//   and keeps their state in its own slice of shared memory: the three
//   hidden layers in degree-sorted order (so the units of degree <= k are
//   a prefix), z, x by dimension, x in visit order, and the NP head
//   parameters (OG floats). Inside a step the warp synchronises with __syncwarp and
//   shuffles only; the step loop has no block barrier.
// - A product splits its fan-in over the 32 lanes; each lane keeps R x G
//   sums (G: 4, 8 or 24 columns of a hidden group, OG of the output
//   group), and a butterfly
//   reduce-scatter of shuffles in one fixed order leaves every sum with one
//   lane. No atomics: a seed repeats bit for bit.
// - The weights each step needs (the degree-k columns cut to their live
//   fan-in, then the NP output columns), degree-sorted and padded to 16
//   bytes, are gathered once into a pack in the walk's order by a first
//   kernel (pack_kernel; the wrapper keeps the pack with the weights). One
//   producer warp a block streams the pack with bulk copies (TMA) into a
//   ring of S shared-memory stages, an mbarrier pair a stage (full: the
//   bytes landed; empty: every consumer warp is done), up to S pieces ahead
//   of the consumers, who read them with LDS. A piece is a run of whole
//   column groups (one-row warps) or one group, or, for a group too large
//   for a stage, one chunk of its fan-in, so every d up to 2730 (h = 8192)
//   fits a block.
// - Small blocks (1-8 consumer warps), so n=256 spreads over ~128 SMs.
// - When a gradient will follow (the sampler's mala/hmc passes), a save
//   instance also writes the state K1-bwd (ar_inverse_backward.cu) reads
//   (SavedState in ar_walk.cuh): each step's head parameters and x as the
//   step leaves them, each transform's hidden signs as bit masks. The
//   instances without it are the same code with the stores compiled out.
// fp32 with plain FMAs, no fast-math; the spline is rqs.cuh's rqs_inverse
// (a one-row warp runs it warp-wide up to 10 bins, where the parameters fit
// a lane each; past that its lane 0 runs the serial one, as a lane a row
// does in warps of 2 or 4 rows), the affine map heads.cuh's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ar_walk.cuh"
#include "made_tile.cuh"  // heads.cuh, rqs.cuh and MAX_SMEM_BYTES

namespace {

using namespace pocomc;
using namespace pocomc::k1;

// The producer: streams the pack (see pack_kernel) through the ring in
// the walk's order. A group whose padded fan-in fits a stage is one bulk
// copy; with `batch` (one-row warps), consecutive such groups go together,
// as many as fit a stage (their layout in the pack is their layout in the
// stage), so a step at small d costs one wait instead of four. A group
// whose padded fan-in does not fit is cut into pieces of chunk_rows rows,
// each a bulk copy a column and one of the biases, landing as column jj at
// jj * round4(rows), then the biases.
struct Producer {
  Ring ring;
  const float* pack;
  long long off;    // floats of the pack before the current group
  long long start;  // ... before the piece being gathered
  int lane;
  bool batch;

  // send the whole groups gathered so far
  __device__ __forceinline__ void flush() {
    if (ring.used == 0) return;
    float* dst = ring.fill_begin();
    uint64_t* bar = ring.full + ring.slot;
    if (lane == 0) {
      mbar_expect(bar, 4u * (uint32_t)ring.used);
      bulk_copy(dst, pack + start, 4u * (uint32_t)ring.used, bar);
    }
    __syncwarp();
    ring.advance();
    ring.used = 0;
  }
  __device__ __forceinline__ void group(int, int, int, int, int ncg, int, int fan) {
    const int fanp = round4(fan), nb = round4(ncg);
    const int ch = chunk_rows(ring.SL, ncg);
    const int floats = (int)group_floats(ncg, fan);
    if (fanp <= ch) {
      if (ring.used + floats > ring.SL) flush();
      if (ring.used == 0) start = off;
      ring.used += floats;
      off += floats;
      if (!batch) flush();
      return;
    }
    flush();
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
    off += floats;
  }
  __device__ __forceinline__ void step_end(int, int) {}
  __device__ __forceinline__ void transform_end(int) {}
};

// rqs_inverse of one row by the whole warp (WARP_SPLINE: up to 10 bins):
// lane j < NPARAMS holds raw parameter j. Lanes 0..BINS-1 and
// BINS..2*BINS-1 take the two softmaxes over the bins (rqs.cuh
// segment_max and segment_sum: every lane of a segment gets the same bits)
// and the knots as an inclusive scan of the bin sizes; the next BINS-1
// lanes the interior derivatives; then every lane gathers the knots and
// runs the same inverse on them. The arithmetic of spline_setup but for
// the order of the two sums where BINS is a power of two, and exactly
// spline_setup's where it is not.
#if !POCOMC_RUNTIME_BINS
__device__ __forceinline__ float rqs_inverse_warp(float y, float p, int lane, float* ladj) {
  const float B = SPLINE_BOUND;
  const float m = segment_max(p, lane);
  const float e = expf(p - m);
  const float s = segment_sum(e, lane);
  const float c = segment_scan((MIN_BIN + (1.0f - MIN_BIN * BINS) * (e / s)) * (2.0f * B), lane);
  const float knot = c - B;
  const float deriv = MIN_DERIV + softplusf(p + SOFTPLUS_INV_1);
  float xk[BINS + 1], yk[BINS + 1], dv[BINS + 1];
  xk[0] = yk[0] = -B;
  xk[BINS] = yk[BINS] = B;
  dv[0] = dv[BINS] = 1.0f;
#pragma unroll
  for (int i = 1; i < BINS; ++i) {
    xk[i] = __shfl_sync(FULL_MASK, knot, i - 1);
    yk[i] = __shfl_sync(FULL_MASK, knot, BINS + i - 1);
    dv[i] = __shfl_sync(FULL_MASK, deriv, 2 * BINS + i - 1);
  }
  return rqs_inverse_knots(y, xk, yk, dv, ladj);
}
#endif

// The consumers of one block: each warp runs every product of the walk on
// its R rows. Row r's state starts at rows + r * RS: h0, h1, h2 (h each,
// degree-sorted), z and x by dimension (d each, swapped between
// transforms), x in visit order (d), the current head parameters (OG, or
// head_floats(np) for the spline of run-time bins).
// With SAVE, rows row0.. (of n) also go to `save` as the walk leaves them.
template <class Head, int R, bool SAVE>
struct Consumer {
  Ring ring;
  Degrees g;
  const int* inv_order;
  float* rows;
  int RS, lane, zo, xo;
  float ladj;  // lane r < R: row r's log-det
  SavedState save;
  int row0, n;
  int np;  // the head's raw parameters

  // one column group over all its fan-in pieces; out[r * RS + jj] =
  // base[r * RS + jj] (when a residual layer) + sum + bias
  template <int G, bool RELU>
  __device__ __forceinline__ void product(const float* in, int fan, int ncg, float* out,
                                          const float* base) {
    __builtin_assume(__isShared(in));
    float acc[R * G];
#pragma unroll
    for (int i = 0; i < R * G; ++i) acc[i] = 0.0f;
    const int ch = chunk_rows(ring.SL, ncg);
    // whole groups share stages in one-row warps (Producer::batch); with
    // more rows, a piece a group measured faster (PERF.md)
    const bool shared = R == 1 && round4(fan) <= ch;
    int i0 = 0, nfp;
    const float* st;
    for (;;) {
      st = shared ? ring.take((int)group_floats(ncg, fan)) : ring.acquire();
      __builtin_assume(__isShared(st));
      const int nf = min(ch, fan - i0);
      nfp = round4(nf);
      for (int i = lane; i < nf; i += 32) {
        float a[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r] = in[r * RS + i0 + i];
          if (RELU) a[r] = fmaxf(a[r], 0.0f);
        }
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          if (jj < ncg) {
            const float w = st[jj * nfp + i];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r * G + jj] = fmaf(a[r], w, acc[r * G + jj]);
          }
        }
      }
      i0 += nf;
      if (i0 >= fan) break;
      ring.release();
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
        if (jj < ncg) {
          const float v = acc[m] + st[ncg * nfp + jj];
          out[r * RS + jj] = base != nullptr ? base[r * RS + jj] + v : v;
        }
      }
    }
    if (!shared) ring.release();
  }

  __device__ __forceinline__ void group(int t, int k, int l, int g0, int ncg, int gw, int fan) {
    const int h = g.h;
    if (l == 3) {
      if constexpr (Head::RUNTIME)
        product<GROUP, true>(rows + 2 * h, fan, ncg, rows + 3 * h + 3 * g.d + g0, nullptr);
      else
        product<Head::OG, true>(rows + 2 * h, fan, ncg, rows + 3 * h + 3 * g.d, nullptr);
      return;
    }
    const int pos = g.count(k - 1) + g0;
    const float* in = l == 0 ? rows + 3 * h + 2 * g.d : rows + (l - 1) * h;
    float* out = rows + l * h + pos;
    const float* base = l == 0 ? nullptr : rows + (l - 1) * h + pos;
    if (l == 0) {
      if (gw == 4) product<4, false>(in, fan, ncg, out, base);
      else if (gw == 8) product<8, false>(in, fan, ncg, out, base);
      else product<GROUP, false>(in, fan, ncg, out, base);
    } else {
      if (gw == 4) product<4, true>(in, fan, ncg, out, base);
      else if (gw == 8) product<8, true>(in, fan, ncg, out, base);
      else product<GROUP, true>(in, fan, ncg, out, base);
    }
  }

  // the inverse of dimension inv_order[t, k]: the spline with one row by
  // the whole warp (rqs_inverse_warp, up to 10 bins); else lane r for row r
  // (the spline of run-time bins streaming over the row's parameters)
  __device__ __forceinline__ void step_end(int t, int k) {
    const int d = g.d, h = g.h;
    const int dim = __ldg(inv_order + t * d + k);
    float* row = rows + 3 * h;  // z, x, x in visit order, head parameters
#if !POCOMC_RUNTIME_BINS
    if constexpr (R == 1 && Head::NP == NPARAMS && WARP_SPLINE) {
      const float p = lane < NPARAMS ? row[3 * d + lane] : 0.0f;
      float l;
      const float x = rqs_inverse_warp(row[zo + dim], p, lane, &l);
      if (lane == 0) {
        row[xo + dim] = x;
        row[2 * d + k] = x;
        ladj += l;
      }
    } else
#endif
    if (lane < R) {
      row += lane * RS;
      float l;
      float x;
      if constexpr (Head::RUNTIME)
        x = Head::inverse(row[zo + dim], ParamsAt<1>{row + 3 * d}, (np + 1) / 3, &l);
      else
        x = Head::inverse(row[zo + dim], row + 3 * d, &l);
      row[xo + dim] = x;
      row[2 * d + k] = x;
      ladj += l;
    }
    __syncwarp();
    if constexpr (SAVE) {
      // value i < NP: the step's parameter i; value NP: its x
      const int NP = Head::RUNTIME ? np : Head::NP;
      for (int r = 0; r < R; ++r) {
        const float* st = rows + r * RS + 3 * h;
        if (row0 + r < n)
          for (int i = lane; i <= NP; i += 32)
            save.px[(((size_t)t * n + row0 + r) * d + k) * (NP + 1) + i] =
                i < NP ? st[3 * d + i] : st[2 * d + k];
      }
    }
  }
  __device__ __forceinline__ void transform_end(int t) {
    const int tmp = zo;
    zo = xo;
    xo = tmp;
    if constexpr (SAVE) {
      // every hidden unit is final: the signs of its pre-activation, a
      // ballot a word
      const int h = g.h, HW = sign_words(h);
      for (int r = 0; r < R; ++r) {
        const bool real = row0 + r < n;
        for (int l = 0; l < 3; ++l) {
          const float* hl = rows + r * RS + l * h;
          unsigned* out = save.signs + (((size_t)t * n + (real ? row0 + r : 0)) * 3 + l) * HW;
          for (int w = 0; w < HW; ++w) {
            const int s = w * 32 + lane;
            const unsigned b = __ballot_sync(FULL_MASK, s < h && hl[s] > 0.0f);
            if (lane == 0 && real) out[w] = b;
          }
        }
      }
    }
  }
};

template <class Head, int R, bool SAVE>
__global__ void __launch_bounds__(32 * (MAX_WARPS + 1))
    ar_inverse_kernel(const float* __restrict__ z, float* __restrict__ x,
                      float* __restrict__ ladj, SavedState save, int n, int d, int h, int T,
                      const float* __restrict__ pack, const int* __restrict__ inv_order, int np,
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
    Producer p{ring, pack, 0, 0, lane, R == 1};
    walk<Head>(g, T, np, p);
    p.flush();
    return;
  }

  const int RS = 3 * h + 3 * d + (Head::RUNTIME ? head_floats(np) : Head::OG);
  const int row0 = (blockIdx.x * W + warp) * R;
  Consumer<Head, R, SAVE> c{ring, g, inv_order, rows + warp * R * RS, RS, lane, 0, d, 0.0f,
                            save, row0, n, Head::RUNTIME ? np : Head::NP};
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    for (int i = lane; i < d; i += 32)
      c.rows[r * RS + 3 * h + i] = row < n ? z[(size_t)row * d + i] : 0.0f;
  }
  __syncwarp();
  walk<Head>(g, T, np, c);
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row < n)
      for (int i = lane; i < d; i += 32) x[(size_t)row * d + i] = c.rows[r * RS + 3 * h + c.zo + i];
  }
  if (lane < R && row0 + lane < n) ladj[row0 + lane] = c.ladj;
}

// The pack: every group of the walk, in its order, laid out as
// group_floats says, from the masked weights (w[l]: (T, K_l, N_l), b[l]:
// (T, N_l)). One block a step (transform, k). Layer 0's fan-in rows are the
// dimensions visited before step k, in visit order; the hidden layers' and
// the output's the degree-sorted hidden units. The hidden layers' columns
// are the degree-k units (k-1) + m*D; the output's the np of dimension
// inv_order[t, k] (in groups of out_cols(np)).
struct Layers {
  const float* w[4];
  const float* b[4];
};

__global__ void pack_kernel(Layers m, const int* __restrict__ inv_order, float* __restrict__ pack,
                            int d, int h, int T, int np) {
  const Degrees g(d, h);
  const int tt = blockIdx.x / d, k = blockIdx.x - tt * d, t = T - 1 - tt;
  long long per_t = 0, off = 0;
  for (int kk = 0; kk < d; ++kk) {
    const long long s = step_floats(g, kk, np);
    per_t += s;
    if (kk < k) off += s;
  }
  off += tt * per_t;
  auto write = [&](int l, int g0, int ncg, int fan) {
    const int K = l == 0 ? d : h;
    const int N = l == 3 ? d * np : h;
    const float* W = m.w[l] + (size_t)t * K * N;
    const float* bias = m.b[l] + (size_t)t * N;
    const int col0 = l == 3 ? inv_order[t * d + k] * np + g0 : (k - 1) + g0 * g.D;
    const int cstep = l == 3 ? 1 : g.D;
    const int fanp = round4(fan), cols = ncg * fanp;
    const int total = cols + round4(ncg);
    float* dst = pack + off;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      float v = 0.0f;
      if (e < cols) {
        const int jj = e / fanp, i = e - jj * fanp;
        if (i < fan) {
          const int row = l == 0 ? inv_order[t * d + i] : g.unit(i);
          v = W[(size_t)row * N + col0 + jj * cstep];
        }
      } else if (e - cols < ncg) {
        v = bias[col0 + (e - cols) * cstep];
      }
      dst[e] = v;
    }
    off += total;
  };
  if (k >= 1) {
    const int nc = g.count(k) - g.count(k - 1);
    const int gw = group_width(nc);
    for (int l = 0; l < 3; ++l)
      for (int g0 = 0; g0 < nc; g0 += gw) write(l, g0, min(gw, nc - g0), l == 0 ? k : g.count(k));
  }
  for (int c0 = 0; c0 < np; c0 += out_cols(np))
    write(3, c0, min(out_cols(np), np - c0), g.count(k));
}

template <class Head, int R, bool SAVE>
int launch(const float* z, float* x, float* ladj, SavedState save, int n, int d, int h, int T,
           const float* pack, const int* inv_order, int np, int W, int S, int SL, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ar_inverse_kernel<Head, R, SAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + R * W - 1) / (R * W);
  ar_inverse_kernel<Head, R, SAVE><<<blocks, 32 * (W + 1), smem, stream>>>(
      z, x, ladj, save, n, d, h, T, pack, inv_order, np, W, S, SL);
  return (int)cudaGetLastError();
}

template <class Head, bool SAVE>
int launch_rows(int rows, const float* z, float* x, float* ladj, SavedState save, int n, int d,
                int h, int T, const float* pack, const int* inv_order, int np, int W, int S,
                int SL, size_t smem, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch<Head, 1, SAVE>(z, x, ladj, save, n, d, h, T, pack, inv_order, np, W, S, SL,
                                   smem, s);
    case 2:
      return launch<Head, 2, SAVE>(z, x, ladj, save, n, d, h, T, pack, inv_order, np, W, S, SL,
                                   smem, s);
    case 4:
      return launch<Head, 4, SAVE>(z, x, ladj, save, n, d, h, T, pack, inv_order, np, W, S, SL,
                                   smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Head>
int launch_save(int rows, const float* z, float* x, float* ladj, SavedState save, int n, int d,
                int h, int T, const float* pack, const int* inv_order, int np, int W, int S,
                int SL, size_t smem, cudaStream_t s) {
  if (save.px != nullptr)
    return launch_rows<Head, true>(rows, z, x, ladj, save, n, d, h, T, pack, inv_order, np, W,
                                   S, SL, smem, s);
  return launch_rows<Head, false>(rows, z, x, ladj, save, n, d, h, T, pack, inv_order, np, W, S,
                                  SL, smem, s);
}


// K1's widest column group with the head of np parameters: a hidden
// group (GROUP) or the output group (OG; GROUP with the spline of run-time
// bins, whose output runs in groups of GROUP)
int widest_group(int np) {
  const int og = RUNTIME_BINS ? GROUP : head_floats(np);
  return og > GROUP ? og : GROUP;
}

}  // namespace

// Floats of the pack of T transforms at (d, h) with a head of np parameters.
extern "C" long long ar_inverse_pack_floats(int d, int h, int T, int np) {
  const Degrees g(d, h);
  long long s = 0;
  for (int k = 0; k < d; ++k) s += step_floats(g, k, np);
  return s * T;
}

// Writes the pack (ar_inverse_pack_floats floats) of the masked weights,
// stacked over transforms as for made_rqs_forward_launch, and the (T, d)
// int32 order in which each transform's inverse visits the dimensions
// (argsort of its autoregressive order); np picks the head (3 BINS - 1 the
// library's spline, 2 the affine map; w3 and b3 have d*np columns). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int ar_inverse_pack_launch(const float* w0, const float* b0, const float* w1,
                                      const float* b1, const float* w2, const float* b2,
                                      const float* w3, const float* b3, const int* inv_order,
                                      float* pack, int d, int h, int T, int np, int device,
                                      void* stream) {
  if (d < 1 || h < 1 || T < 1 || !head_compiled(np)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Layers m{{w0, w1, w2, w3}, {b0, b1, b2, b3}};
  pack_kernel<<<T * d, 256, 0, (cudaStream_t)stream>>>(m, inv_order, pack, d, h, T, np);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes: the inverse of n rows of z
// through the pack that ar_inverse_pack_launch wrote, with the same
// inv_order and np. With save_px non-null, also K1-bwd's state (SavedState
// in ar_walk.cuh): save_px (T, n, d, np + 1) floats and save_signs (T, n, 3,
// ceil(h / 32)) words; both null otherwise. rows (1, 2 or 4) a consumer
// warp, warps (1-8) consumer warps a block, stages (2-8) of stage_floats
// floats in the ring (a multiple of 4, at least 5 times the widest group:
// widest_group). Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int ar_inverse_launch(const float* z, float* x, float* ladj, float* save_px,
                                 unsigned* save_signs, int n, int d, int h, int T,
                                 const float* pack, const int* inv_order, int np, int rows,
                                 int warps, int stages, int stage_floats, int device,
                                 void* stream) {
  if (!head_compiled(np) || (save_px == nullptr) != (save_signs == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t row = 3 * (size_t)h + 3 * (size_t)d + head_floats(np);
  const size_t smem = 16 * (size_t)stages +
                      sizeof(float) * ((size_t)stages * stage_floats + (size_t)warps * rows * row);
  if (n < 1 || d < 1 || h < 1 || T < 1 || warps < 1 || warps > MAX_WARPS || stages < 2 ||
      stages > MAX_STAGES || stage_floats % 4 != 0 || stage_floats < 5 * widest_group(np) ||
      smem > (size_t)MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int W = warps, S = stages, SL = stage_floats;
  const SavedState save{save_px, save_signs};
#if POCOMC_AFFINE
  if (np == AffineHead::NP)
    return launch_save<AffineHead>(rows, z, x, ladj, save, n, d, h, T, pack, inv_order, np, W, S,
                                   SL, smem, s);
#endif
  return launch_save<RqsHead>(rows, z, x, ladj, save, n, d, h, T, pack, inv_order, np, W, S, SL,
                              smem, s);
}
