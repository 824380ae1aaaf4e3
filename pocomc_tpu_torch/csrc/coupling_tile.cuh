// Shared device code of K5's two kernels (coupling_forward.cu,
// coupling_backward.cu) and of K2's backward (made_rqs_backward.cu), the
// last two through stack_backward.cuh: register-tiled fp32 products of a
// block's particle tile with a stack's weights, and the ring that streams
// those weights through shared memory a slab at a time.
//
// Tile geometry. A block has 8 consumer warps (256 threads) and one
// producer warp. The consumers form a grid of row lanes by column lanes
// (Lane): a thread holds an RM x RN tile of accumulators, its rows in
// chunks of min(RM, 4) consecutive rows and its columns in chunks of
// min(RN, 4) consecutive columns, so every fragment is one LDS.64 or
// LDS.128 that the lanes of a row (or column) of the lane grid share.
//  - Tile (every h up to 512, and h = 1024): in a warp the 32 lanes form
//    4 row lanes (the fastest) by 8 column lanes, and the 8 warps 2 row
//    warps by 4 column warps (warp w: rows w & 1, columns w >> 1, so that
//    the four schedulers hold one warp of each column half). A block owns
//    BM = 8*RM rows; a pass covers 32*RN columns.
//  - Row (where a Tile's 8 rows of hidden state do not fit shared memory,
//    from h = 2048): one row lane by 32 column lanes, 8 column warps. A
//    block owns BM = RM rows; a pass covers 256*RN columns.
// A layer wider than a pass (h = 1024 on a Tile, h >= 2048 on a Row) runs
// as several passes of columns, each over the whole contraction.
//
// Layout. Activations sit in shared memory k-major, [k][row] with a row
// stride BMP (a Tile's BM + 4 = 4 mod 8, so that the epilogue's column-wise
// vector stores of the 4 x 8 lane grid land in distinct banks; a Row's BM).
// A weight slab is BK rows of the contraction dimension:
//  - of a layer's row-major (K, N) weight, rows k0..k0+BK and the pass's
//    columns, [k][col] with stride the pass width;
//  - for a product with W^T (the backward), rows j0..j0+BK of W^T, that is
//    columns j0..j0+BK of W, and the pass's columns of W^T, [j][k].
// The producer warp walks the same schedule as the consumers and fills an
// S-stage ring (2-8 stages), one full and one empty mbarrier a stage, so
// the copies of the next S-1 slabs, across layer and transform
// boundaries, run under the current slab's FMAs, and no block-wide
// barrier sits between slabs. A hidden layer's slab is one bulk copy
// (TMA, 1-D), or one a row where the pass is narrower than the layer. An
// output layer's rows are NP*n_trans floats, most of them off a 16-byte
// boundary, and a transposed slab gathers columns: the wrapper repacks
// those weights (Packed) so that each such slab is one bulk copy too.
//
// Sum order. Every product sums its contraction index in ascending order by
// fmaf from 0.0f, one slab after another, then adds the bias (and, on a
// residual layer, is added to the layer's input): the order of
// made_tile.cuh tile_product, whose bits the forward and inverse keep. A
// layer cut into passes of columns sums each column in the same order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "made_tile.cuh"

namespace pocomc {
namespace k5 {

constexpr int NP = RqsHead::NP;

// The consumer threads' grid, RL_ row lanes by 32 / RL_ column lanes in a
// warp and RW_ row warps by 8 / RW_ column warps, and which row lane,
// column lane, row warp and column warp a thread is
template <int RL_, int RW_>
struct Lane {
  static constexpr int RL = RL_, CL = 32 / RL_, RW = RW_, CW = 8 / RW_;
  // rows a block owns, columns a pass covers, and the k-major row stride
  __host__ __device__ static constexpr int rows(int RM) { return RW * RL * RM; }
  __host__ __device__ static constexpr int cols(int RN) { return CW * CL * RN; }
  __host__ __device__ static constexpr int stride(int RM) {
    return RL == 4 ? rows(RM) + 4 : rows(RM);
  }
  int lr, lc, wr, wc;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    lr = lane % RL;
    lc = lane / RL;
    wr = warp % RW;
    wc = warp / RW;
  }
  // whether the thread's warp has a column below w in a pass of RN a thread
  template <int RN>
  __device__ __forceinline__ bool live(int w) const { return wc * CL * RN < w; }
};
using Tile = Lane<4, 2>;
using Row = Lane<1, 1>;

template <int R>
struct Vec {
  static constexpr int W = R < 4 ? R : 4;  // floats a vector access
  static constexpr int N = R / W;          // vector accesses
};

// first row of the thread's row chunk i, first column of its column chunk i
template <int RM, class Ln>
__device__ __forceinline__ int row_of(const Ln& L, int i) {
  return L.wr * Ln::RL * RM + i * Ln::RL * Vec<RM>::W + L.lr * Vec<RM>::W;
}
template <int RN, class Ln>
__device__ __forceinline__ int col_of(const Ln& L, int i) {
  return L.wc * Ln::CL * RN + i * Ln::CL * Vec<RN>::W + L.lc * Vec<RN>::W;
}

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (W == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// acc[r][c] = fmaf(act(A[k][row r]), B[k][col c], acc[r][c]) for k = 0 ..
// bk-1 in order; act is ReLU when RELU. A and B lie in shared memory.
template <int RM, int RN, bool RELU, class Ln>
__device__ __forceinline__ void fma_slab(float (&acc)[RM][RN], const float* A, int lda,
                                         const float* B, int ldb, int bk, const Ln& L) {
  using CR = Vec<RM>;
  using CC = Vec<RN>;
  const float* a0 = A + row_of<RM>(L, 0);
  const float* b0 = B + col_of<RN>(L, 0);
  __builtin_assume(__isShared(a0));
  __builtin_assume(__isShared(b0));
#pragma unroll 4
  for (int k = 0; k < bk; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < CR::N; ++i)
      load_vec<CR::W>(a0 + k * lda + i * Ln::RL * CR::W, a + i * CR::W);
#pragma unroll
    for (int i = 0; i < CC::N; ++i)
      load_vec<CC::W>(b0 + k * ldb + i * Ln::CL * CC::W, b + i * CC::W);
    if (RELU) {
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = fmaxf(a[r], 0.0f);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.0f;
}

// The thread's tile to or from a row-major array in device memory of row
// stride ld whose row 0 is the block's row row0 (and column 0 the pass's
// first): rows < n and columns < w only, 16 bytes an access where the row
// stride allows it. store_rows writes relu(v) when RELU; load_rows reads 0
// outside.
template <int RM, int RN, bool RELU, class Ln>
__device__ __forceinline__ void store_rows(const float (&v)[RM][RN], float* out, int ld, int w,
                                           int row0, int n, const Ln& L) {
  using CR = Vec<RM>;
  using CC = Vec<RN>;
  const bool vec = ld % CC::W == 0;
#pragma unroll
  for (int ri = 0; ri < CR::N; ++ri)
#pragma unroll
    for (int rj = 0; rj < CR::W; ++rj) {
      const int r = ri * CR::W + rj, g = row0 + row_of<RM>(L, ri) + rj;
      if (g >= n) continue;
      float* o = out + (size_t)g * ld;
#pragma unroll
      for (int ci = 0; ci < CC::N; ++ci) {
        const int col = col_of<RN>(L, ci);
        float x[CC::W];
#pragma unroll
        for (int cj = 0; cj < CC::W; ++cj) {
          x[cj] = v[r][ci * CC::W + cj];
          if (RELU) x[cj] = fmaxf(x[cj], 0.0f);
        }
        if (vec && col + CC::W <= w) {
          store_vec<CC::W>(o + col, x);
        } else {
#pragma unroll
          for (int cj = 0; cj < CC::W; ++cj)
            if (col + cj < w) o[col + cj] = x[cj];
        }
      }
    }
}

template <int RM, int RN, class Ln>
__device__ __forceinline__ void load_rows(float (&v)[RM][RN], const float* src, int ld, int w,
                                          int row0, int n, const Ln& L) {
  using CR = Vec<RM>;
  using CC = Vec<RN>;
  const bool vec = ld % CC::W == 0;
#pragma unroll
  for (int ri = 0; ri < CR::N; ++ri)
#pragma unroll
    for (int rj = 0; rj < CR::W; ++rj) {
      const int r = ri * CR::W + rj, g = row0 + row_of<RM>(L, ri) + rj;
      const float* s = src + (size_t)g * ld;
#pragma unroll
      for (int ci = 0; ci < CC::N; ++ci) {
        const int col = col_of<RN>(L, ci);
        float x[CC::W];
        if (g < n && vec && col + CC::W <= w) {
          load_vec<CC::W>(s + col, x);
        } else {
#pragma unroll
          for (int cj = 0; cj < CC::W; ++cj) x[cj] = g < n && col + cj < w ? s[col + cj] : 0.0f;
        }
#pragma unroll
        for (int cj = 0; cj < CC::W; ++cj) v[r][ci * CC::W + cj] = x[cj];
      }
    }
}

// The thread's tile to or from a k-major [col][BMP] array in shared memory
// (columns < w): the elements only this thread reads and writes.
template <int RM, int RN, int BMP, class Ln>
__device__ __forceinline__ void load_tile(float (&v)[RM][RN], const float* S, int w,
                                          const Ln& L) {
  using CR = Vec<RM>;
  using CC = Vec<RN>;
#pragma unroll
  for (int ci = 0; ci < CC::N; ++ci)
#pragma unroll
    for (int cj = 0; cj < CC::W; ++cj) {
      const int col = col_of<RN>(L, ci) + cj;
      if (col >= w) continue;
#pragma unroll
      for (int ri = 0; ri < CR::N; ++ri) {
        float x[CR::W];
        load_vec<CR::W>(S + col * BMP + row_of<RM>(L, ri), x);
#pragma unroll
        for (int rj = 0; rj < CR::W; ++rj) v[ri * CR::W + rj][ci * CC::W + cj] = x[rj];
      }
    }
}

template <int RM, int RN, int BMP, class Ln>
__device__ __forceinline__ void store_tile(const float (&v)[RM][RN], float* S, int w,
                                           const Ln& L) {
  using CR = Vec<RM>;
  using CC = Vec<RN>;
#pragma unroll
  for (int ci = 0; ci < CC::N; ++ci)
#pragma unroll
    for (int cj = 0; cj < CC::W; ++cj) {
      const int col = col_of<RN>(L, ci) + cj;
      if (col >= w) continue;
#pragma unroll
      for (int ri = 0; ri < CR::N; ++ri) {
        float x[CR::W];
#pragma unroll
        for (int rj = 0; rj < CR::W; ++rj) x[rj] = v[ri * CR::W + rj][ci * CC::W + cj];
        store_vec<CR::W>(S + col * BMP + row_of<RM>(L, ri), x);
      }
    }
}

// The residual MLPs of T coupling transforms (models/coupling.py), each
// its own (K, N) weights and (N,) biases: tab holds 8T device pointers,
// w0 b0 w1 b1 w2 b2 w3 b3 of transform 0, then of 1, and so on. The halves
// alternate as make_coupling_masks lays them out: an even transform
// conditions on dimensions [0, half) and transforms [half, d), an odd one
// conditions on [half, d) and transforms [0, half), half = ceil(d/2).
// Or, with made_b3 set, the T masked MADE networks of an autoregressive
// stack (K2's backward, made_rqs_backward.cu): every transform reads all d
// dimensions and transforms all d, its masked weights taken as dense; its
// kernel streams every weight from the packed copies (Packed) and reads
// only the output biases, made_b3 (T, d*np). np is the head's raw
// parameters a transformed dimension (heads.cuh).
struct Coupling {
  const float* const* tab;
  int d, h, T;
  int np = NP;
  const float* made_b3 = nullptr;
  __host__ __device__ __forceinline__ bool made() const { return made_b3 != nullptr; }
  __host__ __device__ __forceinline__ int half() const { return (d + 1) / 2; }
  // the most dimensions a transform conditions on or transforms
  __host__ __device__ __forceinline__ int wide() const { return made() ? d : half(); }
  __device__ __forceinline__ int n_cond(int t) const {
    return made() ? d : (t & 1) ? d - half() : half();
  }
  __device__ __forceinline__ int cond0(int t) const { return made() || !(t & 1) ? 0 : half(); }
  __device__ __forceinline__ int trans0(int t) const { return made() || (t & 1) ? 0 : half(); }
  __device__ __forceinline__ int n_trans(int t) const { return made() ? d : d - n_cond(t); }
  __device__ __forceinline__ int fan_in(int t, int l) const { return l == 0 ? n_cond(t) : h; }
  __device__ __forceinline__ int fan_out(int t, int l) const {
    return l == 3 ? n_trans(t) * np : h;
  }
  __device__ __forceinline__ const float* weights(int t, int l) const { return tab[8 * t + 2 * l]; }
  __device__ __forceinline__ const float* biases(int t, int l) const {
    return made() ? made_b3 + (size_t)t * d * np : tab[8 * t + 2 * l + 1];
  }
};

// One pass of the schedule: a product over layer l of transform t into
// outputs [o0, o0 + no). Plain (trans false): the contraction runs over
// the len = K rows of W (c0 = 0), the outputs are columns of its N.
// Transposed: the contraction runs over rows [c0, c0 + len) of W^T
// (columns of W), the outputs are rows of W, of its K.
struct Pass {
  int t, l;
  bool trans;
  int c0, len;
  int o0, no;
};

// Weights repacked by the wrapper so that every slab is one contiguous,
// 16-byte aligned block (the rows of an output layer are NP*n_trans floats,
// which leaves most of them off a 16-byte boundary): w3 (forward), each
// transform's output groups as (T, NG, h, ldo) blocks, a group's columns
// zero-padded to ldo, the output pass width (with the spline of run-time
// bins, a group wider than that as Plan::subs blocks of ldo columns,
// (T, NG, subs, h, ldo)); wt (backward), each
// transform's four weights transposed, W0^T (h rows, n_cond of its k),
// W1^T, W2^T, then W3^T (one row per output column, np*wide), each cut
// into passes of PW columns of k (k zero-padded to a whole pass: the
// halves' ceil(wide / PW) passes for W0^T, ceil(h / PW) for the others),
// a layer's passes one after another, each (rows, PW). At h <= PW that is
// (T, 3h + np*wide, PW); wide is Coupling::wide(), half a coupling
// stack's d or all d of a MADE one. wt is null in the forward.
struct Packed {
  const float* w3;
  const float* wt;
  int NG;

  // the first float of output group g of transform t in w3
  __device__ __forceinline__ const float* w3_group(int t, int g, int h, int ldo) const {
    return w3 + ((size_t)t * NG + g) * h * ldo;
  }
  // the first row of pass c of layer l's W^T of transform t in wt
  __device__ __forceinline__ const float* wt_pass(int t, int l, int c, int h, int wide,
                                                  int np, int PW) const {
    const size_t p0 = (wide + PW - 1) / PW, ph = (h + PW - 1) / PW;
    const size_t sec = l == 0 ? 0 : p0 * h + (l - 1) * ph * h;
    const size_t per_t = p0 * h + 2 * ph * h + ph * wide * np;
    return wt + ((size_t)t * per_t + sec + (size_t)c * (l == 3 ? wide * np : h)) * PW;
  }
};

// The schedule both the loader and the consumers walk, every thread alike:
// transforms 0..T-1 (T-1..0 with rev); in the forward each transform is
// layers 0, 1, 2, each nh = ceil(h / PW) passes of PW columns (the caller
// passes nh: a kernel instance that only takes h <= PW passes the constant
// 1, so its schedule folds to PR 7's), and one
// pass per output group of G whole transformed dimensions; in the
// backward (bwd) each output group's parameters (unless psaved: the
// kernel reads the parameters a save instance wrote), then nh passes of
// their gradients through W3^T, then nh passes each of W2^T and W1^T and
// the passes of W0^T over the conditioning half. A pass is cut into slabs
// of BK contraction rows.
struct Plan {
  Coupling m;
  int G, BK, PW;
  bool bwd, rev;
  Packed pk;
  bool psaved = false;
  int OW = 0;  // columns of an output pass

  __device__ __forceinline__ int transform(int i) const { return rev ? m.T - 1 - i : i; }
  __device__ __forceinline__ int groups(int t) const { return (m.n_trans(t) + G - 1) / G; }
  __device__ __forceinline__ int nh() const { return (m.h + PW - 1) / PW; }
  // passes of an output group's product: one, but for the spline of
  // run-time bins, whose group, then one dimension (G = 1, so every group
  // is as wide), may be wider than an output pass
  __device__ __forceinline__ int subs() const {
    if constexpr (RUNTIME_BINS) return (G * m.np + OW - 1) / OW;
    return 1;
  }
  // the backward's passes a group: its parameters' (unless psaved) and nh
  // through W3^T
  __device__ __forceinline__ int per(int nh) const { return (psaved ? 0 : subs()) + nh; }
  __device__ __forceinline__ int passes(int t, int nh) const {
    return bwd ? groups(t) * per(nh) + 2 * nh + (m.n_cond(t) + PW - 1) / PW
               : 3 * nh + groups(t) * subs();
  }
  // output pass j of the group of columns [c0, c0 + w)
  __device__ __forceinline__ Pass out_pass(int t, int c0, int w, int j) const {
    if (subs() == 1) return Pass{t, 3, false, 0, m.h, c0, w};
    const int o0 = c0 + j * OW;
    return Pass{t, 3, false, 0, m.h, o0, min(OW, c0 + w - o0)};
  }
  __device__ __forceinline__ Pass pass(int t, int p, int nh) const {
    const int h = m.h, n3 = m.n_trans(t) * m.np, gw = G * m.np, s = subs();
    if (!bwd) {
      if (p < 3 * nh) {
        const int l = p / nh, o0 = (p - l * nh) * PW;
        return Pass{t, l, false, 0, l == 0 ? m.n_cond(t) : h, o0, min(PW, h - o0)};
      }
      const int g = (p - 3 * nh) / s, c0 = g * gw;
      return out_pass(t, c0, min(gw, n3 - c0), p - 3 * nh - g * s);
    }
    const int per = this->per(nh);
    if (p < groups(t) * per) {
      const int g = p / per, r = p - g * per + (psaved ? s : 0), c0 = g * gw,
                w = min(gw, n3 - c0);
      if (r < s) return out_pass(t, c0, w, r);
      const int o0 = (r - s) * PW;
      return Pass{t, 3, true, c0, w, o0, min(PW, h - o0)};
    }
    p -= groups(t) * per;
    if (p < 2 * nh) {
      const int l = 2 - p / nh, o0 = (p % nh) * PW;
      return Pass{t, l, true, 0, h, o0, min(PW, h - o0)};
    }
    const int o0 = (p - 2 * nh) * PW;
    return Pass{t, 0, true, 0, h, o0, min(PW, m.n_cond(t) - o0)};
  }
  __device__ __forceinline__ int slabs(const Pass& q) const { return (q.len + BK - 1) / BK; }
  // the packed slab block of an output pass that starts at column o0:
  // block (t, group, pass of the group) of Packed w3
  __device__ __forceinline__ const float* w3_block(int t, int o0, int h, int ldo) const {
    const int gw = G * m.np, g = o0 / gw;
    if (subs() == 1) return pk.w3_group(t, g, h, ldo);
    return pk.w3 + (((size_t)t * pk.NG + g) * subs() + (o0 - g * gw) / OW) * h * ldo;
  }
};

// a place in the schedule: transform index i of the walk, pass p, slab s
struct Cursor {
  int i, p, s;
};

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

// the block's 8 consumer warps meet (the producer warp does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// A block: THREADS consumer threads (8 warps) and one producer warp
constexpr int BLOCK = THREADS + 32;
constexpr int MAX_STAGES = 8;

// The S-stage ring of weight slabs, as one side sees it: slab i lands in
// stage i mod S; `phase` is the parity of the round (i / S). full[s]: the
// producer warp's 32 lanes arrive and its copies land; empty[s]: each
// consumer warp arrives when done with the stage. A slab's row stride
// (floats) is ldh for a hidden layer's plain slab and every transposed one
// (the hidden pass width PW), ldo for an output group's plain slab (the
// output pass width); a stage holds BK rows of the larger.
struct Ring {
  Plan pl;
  float* base;
  uint64_t* full;
  uint64_t* empty;
  int stage_floats, S, ldh, ldo;
  int slot;
  uint32_t phase;
  bool wrapped;

  __device__ __forceinline__ int ld_of(const Pass& q) const {
    return q.trans || q.l < 3 ? ldh : ldo;
  }
  __device__ __forceinline__ void next_stage() {
    if (++slot == S) {
      slot = 0;
      phase ^= 1u;
      wrapped = true;
    }
  }
  // consumer: the stage of the next slab, once it has landed
  __device__ __forceinline__ const float* acquire() {
    mbar_wait(full + slot, phase);
    return base + slot * stage_floats;
  }
  // consumer: done with the stage (this warp's reads of it are issued)
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
    next_stage();
  }
};

// The producer warp: walks the schedule and copies each slab into the next
// stage once every consumer warp has left it, by bulk copies (TMA): a
// slab of the packed weights (an output group's, a transposed one) is one
// copy, a plain slab of a hidden layer one copy, or one a row where the
// pass is narrower than the layer.
__device__ __forceinline__ void produce(Ring ring) {
  const Plan& pl = ring.pl;
  const int lane = threadIdx.x & 31, nh = pl.nh();
  for (Cursor c{0, 0, 0}; c.i < pl.m.T; ++c.i) {
    const int t = pl.transform(c.i);
    for (c.p = 0; c.p < pl.passes(t, nh); ++c.p) {
      const Pass q = pl.pass(t, c.p, nh);
      const int N = pl.m.fan_out(t, q.l), ldn = ring.ld_of(q), ns = pl.slabs(q);
      const float* packed =
          q.trans ? pl.pk.wt_pass(t, q.l, q.o0 / pl.PW, pl.m.h, pl.m.wide(), pl.m.np, pl.PW)
                  : (q.l == 3 ? pl.w3_block(t, q.o0, q.len, ldn) : nullptr);
      for (c.s = 0; c.s < ns; ++c.s) {
        if (ring.wrapped) mbar_wait(ring.empty + ring.slot, ring.phase ^ 1u);
        float* dst = ring.base + ring.slot * ring.stage_floats;
        uint64_t* bar = ring.full + ring.slot;
        const int k0 = q.c0 + c.s * pl.BK, bk = min(pl.BK, q.c0 + q.len - k0);
        if (packed != nullptr) {
          if (lane == 0) {
            mbar_expect(bar, 4u * (uint32_t)(bk * ldn));
            bulk_copy(dst, packed + (size_t)k0 * ldn, 4u * (uint32_t)(bk * ldn), bar);
          } else {
            mbar_arrive(bar);
          }
        } else {
          const float* src = pl.m.weights(t, q.l) + (size_t)k0 * N + q.o0;
          if (lane == 0) mbar_expect(bar, 4u * (uint32_t)(bk * q.no));
          __syncwarp();
          if (q.no == ldn && q.no == N) {
            if (lane == 0) bulk_copy(dst, src, 4u * (uint32_t)(bk * N), bar);
          } else {
            for (int kk = lane; kk < bk; kk += 32)
              bulk_copy(dst + kk * ldn, src + (size_t)kk * N, 4u * (uint32_t)q.no, bar);
          }
          if (lane != 0) mbar_arrive(bar);
        }
        ring.next_stage();
      }
    }
  }
}

// acc over one whole pass: A (k-major, stride lda, already offset to the
// pass's first contraction row) times the pass's slabs from the ring
template <int RM, int RN, bool RELU, class Ln>
__device__ __forceinline__ void run_pass(float (&acc)[RM][RN], Ring& ring, const Pass& q,
                                         const float* A, int lda, const Ln& L) {
  const int ldb = ring.ld_of(q);
  const bool live = L.template live<RN>(q.no);  // the warp has a column of the pass
  for (int k0 = 0; k0 < q.len; k0 += ring.pl.BK) {
    const float* B = ring.acquire();
    if (live)
      fma_slab<RM, RN, RELU>(acc, A + k0 * lda, lda, B, ldb, min(ring.pl.BK, q.len - k0), L);
    ring.release();
  }
}

// Sets up a kernel's ring after `used` floats of tile state: the stages
// from the next 16-byte boundary, then the 2*S mbarriers. Every thread of
// the block calls it; the block's barrier inside orders the initialisation
// before any use.
__device__ __forceinline__ Ring make_ring(const Plan& pl, float* smem, int used, int S, int BK,
                                          int ldh, int ldo) {
  const int stage_floats = BK * (ldh > ldo ? ldh : ldo);
  float* base = smem + ((used + 3) & ~3);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + S * stage_floats);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + s, 32);
      mbar_init(bars + S + s, THREADS / 32);
    }
  }
  __syncthreads();
  return Ring{pl, base, bars, bars + S, stage_floats, S, ldh, ldo, 0, 0u, false};
}

// the shared-memory floats of a ring: S stages of BK rows of the wider of
// the hidden (ldh) and output (ldo) pass widths, padding and 2*S mbarriers
__host__ __device__ __forceinline__ int ring_floats(int S, int BK, int ldh, int ldo) {
  return 4 + S * BK * (ldh > ldo ? ldh : ldo) + 4 * S;
}

// Whether a kernel instance runs hidden layers in several passes of
// columns: a Row's, and a Tile's of the widest register tile (h = 512 in
// one pass, 1024 in two). The others take h <= 32*RNH, one pass.
template <class Ln, int RNH>
__host__ __device__ constexpr bool multi_pass() {
  return Ln::RL == 1 || RNH >= 16;
}

// the launch checks the entry points make; RL is the tile's row lanes, 4
// a Tile (BM = 8, 16, 32 or 64) and 1 a Row (BM = 1, 2 or 4); h a multiple
// of 4, so that a hidden layer's rows are whole bulk copies, and within one
// pass on a Tile below RNH = 16; an output group of G whole dimensions of
// m (at most m.wide()) within an output pass, or, with the spline of
// run-time bins, of one dimension in several (Plan::subs)
__host__ __forceinline__ bool k5_args_ok(int RL, int BM, int RNH, int RNO, int G, int BK, int S,
                                         const Coupling& m, size_t smem) {
  const bool tile = RL == 4 ? (BM == 8 || BM == 16 || BM == 32 || BM == 64)
                            : RL == 1 && (BM == 1 || BM == 2 || BM == 4);
  const int OW = RL == 4 ? Tile::cols(RNO) : Row::cols(RNO);
  return smem <= (size_t)MAX_SMEM_BYTES && tile && m.d >= (m.made() ? 1 : 2) && m.h >= 4 &&
         m.h % 4 == 0 && (RL == 1 || RNH >= 16 || m.h <= Tile::cols(RNH)) && G >= 1 &&
         G <= m.wide() && (G * m.np <= OW || (RUNTIME_BINS && G == 1)) && BK >= 4 &&
         BK <= 128 && BK % 4 == 0 && S >= 2 && S <= MAX_STAGES;
}

}  // namespace k5
}  // namespace pocomc
