// K1: autoregressive inverse of a whole masked autoregressive transform
// stack, latent -> data, with the summed log|det dx/dz|. The element
// transform is the head (heads.cuh), a template parameter: the 8-bin
// spline of the nsf* flows or the affine map of the maf* flows.
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
// from the layer-2 units of degree <= k (23 for the spline, 2 for the
// affine map), then that dimension's inverse. Masked-out terms are
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
//   a prefix), z, x by dimension, x in visit order, and 23 spline
//   head parameters (OG floats). Inside a step the warp synchronises with __syncwarp and
//   shuffles only; the step loop has no block barrier.
// - A product splits its fan-in over the 32 lanes; each lane keeps R x G
//   sums (G: 4, 8 or 24 columns of a group), and a butterfly
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
// fp32 with plain FMAs, no fast-math; the spline is rqs.cuh's rqs_inverse
// (a one-row warp runs it warp-wide), the affine map heads.cuh's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "made_tile.cuh"  // heads.cuh, rqs.cuh and MAX_SMEM_BYTES

namespace {

using namespace pocomc;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int GROUP = 24;       // widest column group: one dimension's spline parameters
constexpr int MAX_WARPS = 8;    // consumer warps a block
constexpr int MAX_STAGES = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrives on bar and adds `bytes` to the transfers its phase waits for
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one bulk copy (TMA, 1-D) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, counted against bar's transfers
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Hidden-unit degrees for (d, h): unit u has degree u mod D + 1; with
// h = q*D + r, degrees 1..r have q + 1 units and r+1..D have q. The
// degree-sorted order lists degree 1's units (0, D, 2D, ...), then degree
// 2's, and so on.
struct Degrees {
  int d, h, D, q, r;
  __host__ __device__ Degrees(int d_, int h_) : d(d_), h(h_), D(max(1, d_ - 1)) {
    q = h / D;
    r = h - q * D;
  }
  // units of degree <= k: the first count(k) places of the sorted order
  __host__ __device__ __forceinline__ int count(int k) const {
    return k >= D ? h : q * k + min(k, r);
  }
  // the unit at place s of the sorted order
  __device__ __forceinline__ int unit(int s) const {
    const int big = r * (q + 1);
    int j, m;
    if (s < big) {
      j = s / (q + 1);
      m = s - j * (q + 1);
    } else {
      const int s2 = s - big, jr = s2 / q;
      j = r + jr;
      m = s2 - jr * q;
    }
    return j + m * D;
  }
};

__host__ __device__ __forceinline__ int group_width(int nc) {
  return nc <= 4 ? 4 : (nc <= 8 ? 8 : GROUP);
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// A group of ncg columns with fan-in fan in the pack: column jj's fan-in
// at jj * round4(fan), zero-padded, then the ncg biases padded to 4, so
// that every group and every column starts on 16 bytes.
__host__ __device__ __forceinline__ long long group_floats(int ncg, int fan) {
  return (long long)ncg * round4(fan) + round4(ncg);
}

// fan-in rows of one piece of a group of ncg columns, a multiple of 4:
// ncg columns of them and the padded biases fill at most SL floats
__device__ __forceinline__ int chunk_rows(int SL, int ncg) {
  return ((SL - round4(ncg)) / ncg) & ~3;
}

// The order of the products, shared by the producer and the consumers:
// transforms T-1..0, steps k = 0..d-1; at k >= 1 the degree-k column
// groups of layers 0, 1, 2, then (every k) the output group of
// dimension inv_order[t, k] (the head's NP columns in a group of OG),
// then the step's end. v.group(t, k, layer, g0, ncg, gw, fan) gets the
// group's first column among the step's columns of that layer, its
// width, the group width and the fan-in.
template <class Head, class Visitor>
__device__ __forceinline__ void walk(const Degrees& g, int T, Visitor& v) {
  for (int tt = 0; tt < T; ++tt) {
    const int t = T - 1 - tt;
    for (int k = 0; k < g.d; ++k) {
      if (k >= 1) {
        const int nc = g.count(k) - g.count(k - 1);
        const int gw = group_width(nc);
        for (int l = 0; l < 3; ++l)
          for (int g0 = 0; g0 < nc; g0 += gw)
            v.group(t, k, l, g0, min(gw, nc - g0), gw, l == 0 ? k : g.count(k));
      }
      v.group(t, k, 3, 0, Head::NP, Head::OG, g.count(k));
      v.step_end(t, k);
    }
    v.transform_end();
  }
}

// floats of step k's groups in the pack (the groups walk() visits) with a
// head of np parameters
__host__ __device__ inline long long step_floats(const Degrees& g, int k, int np) {
  long long s = group_floats(np, g.count(k));
  if (k >= 1) {
    const int nc = g.count(k) - g.count(k - 1);
    const int gw = group_width(nc);
    for (int g0 = 0; g0 < nc; g0 += gw) {
      const int ncg = min(gw, nc - g0);
      s += group_floats(ncg, k) + 2 * group_floats(ncg, g.count(k));
    }
  }
  return s;
}

// The stage ring as one side sees it: piece i lands in stage i mod S;
// `phase` is the parity of the round (i / S) the current stage is in. A
// piece is either consecutive whole groups of the walk, as many as fit a
// stage, or one fan-in chunk of a group too large for one.
struct Ring {
  float* stage;
  uint64_t* full;   // S barriers: the producer arrives, and its copies land
  uint64_t* empty;  // S barriers: each consumer warp arrives when done
  int S, SL;
  int slot;
  uint32_t phase;
  bool wrapped;  // past the first round: a stage must be emptied before a refill
  bool held;     // consumer: holds the current stage's groups
  int used;      // floats of the piece taken (consumer) or gathered (producer)

  __device__ __forceinline__ void advance() {
    if (++slot == S) {
      slot = 0;
      phase ^= 1u;
      wrapped = true;
    }
  }
  // consumer: done with the piece (its lanes' reads and writes before)
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
    advance();
  }
  // consumer: the next piece, once it has landed, giving up a held one
  __device__ __forceinline__ const float* acquire() {
    if (held) {
      release();
      held = false;
    }
    mbar_wait(full + slot, phase);
    return stage + slot * SL;
  }
  // consumer: the next whole group of `floats`, in the held piece or the
  // next one
  __device__ __forceinline__ const float* take(int floats) {
    if (held && used + floats <= SL) {
      used += floats;
      return stage + slot * SL + used - floats;
    }
    const float* st = acquire();
    held = true;
    used = floats;
    return st;
  }
  // producer: the stage for the next piece, once every consumer left it
  __device__ __forceinline__ float* fill_begin() const {
    if (wrapped) mbar_wait(empty + slot, phase ^ 1u);
    return stage + slot * SL;
  }
};

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
      if (lane < ncg) bulk_copy(dst + lane * nfp, blk + lane * fanp + i0, 4u * nfp, bar);
      if (lane == ncg) bulk_copy(dst + ncg * nfp, blk + ncg * fanp, 4u * nb, bar);
      ring.advance();
      i0 += nf;
    } while (i0 < fan);
    off += floats;
  }
  __device__ __forceinline__ void step_end(int, int) {}
  __device__ __forceinline__ void transform_end() {}
};

__host__ __device__ constexpr int halvings(int v, int left = 5) {
  return (left > 0 && v % 2 == 0) ? 1 + halvings(v / 2, left - 1) : 0;
}

// Butterfly over the warp's lanes at xor-offsets 16, 8, 4, 2, 1: while the
// count of sums a lane holds is even, each level hands half of them to the
// partner and adds the partner's half of its own; once odd, it adds the
// partner's copies (both sides get the same bits). After it, lane l holds
// the full sums of values [c*Q, c*Q + Q), c = l >> (5 - H), in v[0..Q).
template <int SIZE, int LV, int V>
__device__ __forceinline__ void reduce_level(float (&v)[V], int lane) {
  if constexpr (LV < 5) {
    constexpr int o = 16 >> LV;
    if constexpr (SIZE % 2 == 0) {
      constexpr int half = SIZE / 2;
      const bool hi = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = hi ? v[i] : v[i + half];
        const float keep = hi ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL_MASK, send, o);
      }
      reduce_level<half, LV + 1>(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < SIZE; ++i) v[i] += __shfl_xor_sync(FULL_MASK, v[i], o);
      reduce_level<SIZE, LV + 1>(v, lane);
    }
  }
}

// rqs_inverse of one row by the whole warp: lane j < NPARAMS holds raw
// parameter j. Lanes 0-7 and 8-15 take the two softmaxes over the bins
// (max and sum by xor-butterflies, so every lane of a group gets the same
// bits) and the knots as an inclusive scan of the bin sizes; lanes 16-22
// the interior derivatives; then every lane gathers the knots and runs the
// same inverse on them. The arithmetic of spline_setup but for the order
// of the two sums.
__device__ __forceinline__ float rqs_inverse_warp(float y, float p, int lane, float* ladj) {
  const float B = SPLINE_BOUND;
  float m = p;
#pragma unroll
  for (int o = 4; o >= 1; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
  const float e = expf(p - m);
  float s = e;
#pragma unroll
  for (int o = 4; o >= 1; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
  float c = (MIN_BIN + (1.0f - MIN_BIN * BINS) * (e / s)) * (2.0f * B);
#pragma unroll
  for (int o = 1; o < BINS; o <<= 1) {
    const float v = __shfl_up_sync(FULL_MASK, c, o);
    if ((lane & (BINS - 1)) >= o) c += v;
  }
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

// The consumers of one block: each warp runs every product of the walk on
// its R rows. Row r's state starts at rows + r * RS: h0, h1, h2 (h each,
// degree-sorted), z and x by dimension (d each, swapped between
// transforms), x in visit order (d), the current head parameters (OG).
template <class Head, int R>
struct Consumer {
  Ring ring;
  Degrees g;
  const int* inv_order;
  float* rows;
  int RS, lane, zo, xo;
  float ladj;  // lane r < R: row r's log-det

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
  // the whole warp (rqs_inverse_warp); else lane r for row r
  __device__ __forceinline__ void step_end(int t, int k) {
    const int d = g.d, h = g.h;
    const int dim = __ldg(inv_order + t * d + k);
    float* row = rows + 3 * h;  // z, x, x in visit order, head parameters
    if constexpr (R == 1 && Head::NP == NPARAMS) {
      const float p = lane < NPARAMS ? row[3 * d + lane] : 0.0f;
      float l;
      const float x = rqs_inverse_warp(row[zo + dim], p, lane, &l);
      if (lane == 0) {
        row[xo + dim] = x;
        row[2 * d + k] = x;
        ladj += l;
      }
    } else if (lane < R) {
      row += lane * RS;
      float l;
      const float x = Head::inverse(row[zo + dim], row + 3 * d, &l);
      row[xo + dim] = x;
      row[2 * d + k] = x;
      ladj += l;
    }
    __syncwarp();
  }
  __device__ __forceinline__ void transform_end() {
    const int tmp = zo;
    zo = xo;
    xo = tmp;
  }
};

template <class Head, int R>
__global__ void __launch_bounds__(32 * (MAX_WARPS + 1))
    ar_inverse_kernel(const float* __restrict__ z, float* __restrict__ x,
                      float* __restrict__ ladj, int n, int d, int h, int T,
                      const float* __restrict__ pack, const int* __restrict__ inv_order, int W,
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
    Producer p{ring, pack, 0, 0, lane, R == 1};
    walk<Head>(g, T, p);
    p.flush();
    return;
  }

  const int RS = 3 * h + 3 * d + Head::OG;
  const int row0 = (blockIdx.x * W + warp) * R;
  Consumer<Head, R> c{ring, g, inv_order, rows + warp * R * RS, RS, lane, 0, d, 0.0f};
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    for (int i = lane; i < d; i += 32)
      c.rows[r * RS + 3 * h + i] = row < n ? z[(size_t)row * d + i] : 0.0f;
  }
  __syncwarp();
  walk<Head>(g, T, c);
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
// inv_order[t, k].
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
    const int col0 = l == 3 ? inv_order[t * d + k] * np : (k - 1) + g0 * g.D;
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
  write(3, 0, np, g.count(k));
}

template <class Head, int R>
int launch(const float* z, float* x, float* ladj, int n, int d, int h, int T, const float* pack,
           const int* inv_order, int W, int S, int SL, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ar_inverse_kernel<Head, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + R * W - 1) / (R * W);
  ar_inverse_kernel<Head, R><<<blocks, 32 * (W + 1), smem, stream>>>(z, x, ladj, n, d, h, T, pack,
                                                                    inv_order, W, S, SL);
  return (int)cudaGetLastError();
}

template <class Head>
int launch_rows(int rows, const float* z, float* x, float* ladj, int n, int d, int h, int T,
                const float* pack, const int* inv_order, int W, int S, int SL, size_t smem,
                cudaStream_t s) {
  switch (rows) {
    case 1: return launch<Head, 1>(z, x, ladj, n, d, h, T, pack, inv_order, W, S, SL, smem, s);
    case 2: return launch<Head, 2>(z, x, ladj, n, d, h, T, pack, inv_order, W, S, SL, smem, s);
    case 4: return launch<Head, 4>(z, x, ladj, n, d, h, T, pack, inv_order, W, S, SL, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool head_ok(int np) { return np == RqsHead::NP || np == AffineHead::NP; }

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
// (argsort of its autoregressive order); np picks the head (23 the spline,
// 2 the affine map; w3 and b3 have d*np columns). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int ar_inverse_pack_launch(const float* w0, const float* b0, const float* w1,
                                      const float* b1, const float* w2, const float* b2,
                                      const float* w3, const float* b3, const int* inv_order,
                                      float* pack, int d, int h, int T, int np, int device,
                                      void* stream) {
  if (d < 1 || h < 1 || T < 1 || !head_ok(np)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Layers m{{w0, w1, w2, w3}, {b0, b1, b2, b3}};
  pack_kernel<<<T * d, 256, 0, (cudaStream_t)stream>>>(m, inv_order, pack, d, h, T, np);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes: the inverse of n rows of z
// through the pack that ar_inverse_pack_launch wrote, with the same
// inv_order and np. rows (1, 2 or 4) a consumer warp, warps (1-8) consumer warps a
// block, stages (2-8) of stage_floats floats in the ring (a multiple of 4,
// at least 5 * 24). Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int ar_inverse_launch(const float* z, float* x, float* ladj, int n, int d, int h,
                                 int T, const float* pack, const int* inv_order, int np,
                                 int rows, int warps, int stages, int stage_floats, int device,
                                 void* stream) {
  if (!head_ok(np)) return (int)cudaErrorInvalidValue;
  const size_t row =
      3 * (size_t)h + 3 * (size_t)d + (np == AffineHead::NP ? AffineHead::OG : RqsHead::OG);
  const size_t smem = 16 * (size_t)stages +
                      sizeof(float) * ((size_t)stages * stage_floats + (size_t)warps * rows * row);
  if (n < 1 || d < 1 || h < 1 || T < 1 || warps < 1 || warps > MAX_WARPS || stages < 2 ||
      stages > MAX_STAGES || stage_floats % 4 != 0 || stage_floats < 5 * GROUP ||
      smem > (size_t)MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int W = warps, S = stages, SL = stage_floats;
  if (np == AffineHead::NP)
    return launch_rows<AffineHead>(rows, z, x, ladj, n, d, h, T, pack, inv_order, W, S, SL, smem,
                                   s);
  return launch_rows<RqsHead>(rows, z, x, ladj, n, d, h, T, pack, inv_order, W, S, SL, smem, s);
}
