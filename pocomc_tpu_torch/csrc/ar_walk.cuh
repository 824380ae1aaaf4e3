// Shared device code of K1 (ar_inverse.cu) and its backward K1-bwd
// (ar_inverse_backward.cu): the MADE degrees, the order of the degree
// walk and its reverse, the layout of the weight pack both read (one pack,
// written by K1's pack_kernel), the ring of shared-memory stages a
// producer warp fills with bulk copies (TMA) behind mbarriers, and the
// butterfly reduction of a warp's partial sums.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "heads.cuh"

namespace pocomc {
namespace k1 {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int GROUP = 24;       // widest hidden column group (the output group is the head's OG)
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

// columns of a step's output group with a head of np parameters: the whole
// head (one group), but GROUP with the spline of run-time bins, whose NP
// columns run as groups of GROUP as a hidden layer's do
__host__ __device__ __forceinline__ int out_cols(int np) { return RUNTIME_BINS ? GROUP : np; }

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
// dimension inv_order[t, k] (the head's NP columns in a group of OG; the
// np columns of the spline of run-time bins in groups of GROUP), then the
// step's end. v.group(t, k, layer, g0, ncg, gw, fan) gets the group's
// first column among the step's columns of that layer, its width, the
// group width and the fan-in.
template <class Head, class Visitor>
__device__ __forceinline__ void walk(const Degrees& g, int T, int np, Visitor& v) {
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
      if constexpr (Head::RUNTIME) {
        for (int c0 = 0; c0 < np; c0 += GROUP)
          v.group(t, k, 3, c0, min(GROUP, np - c0), GROUP, g.count(k));
      } else {
        v.group(t, k, 3, 0, Head::NP, Head::OG, g.count(k));
      }
      v.step_end(t, k);
    }
    v.transform_end(t);
  }
}

// The reverse of walk(): transforms 0..T-1, steps k = d-1..0; in each step
// the output group first, then layers 2, 1, 0, each layer's groups last
// first. K1-bwd's order: each group of the pack, in reverse, so consecutive
// groups of this walk are one contiguous range of the pack.
template <class Head, class Visitor>
__device__ __forceinline__ void walk_back(const Degrees& g, int T, int np, Visitor& v) {
  for (int t = 0; t < T; ++t) {
    v.transform_begin(t);
    for (int k = g.d - 1; k >= 0; --k) {
      if constexpr (Head::RUNTIME) {
        for (int c0 = (np - 1) / GROUP * GROUP; c0 >= 0; c0 -= GROUP)
          v.group(t, k, 3, c0, min(GROUP, np - c0), GROUP, g.count(k));
      } else {
        v.group(t, k, 3, 0, Head::NP, Head::OG, g.count(k));
      }
      if (k >= 1) {
        const int nc = g.count(k) - g.count(k - 1);
        const int gw = group_width(nc);
        for (int l = 2; l >= 0; --l)
          for (int g0 = (nc - 1) / gw * gw; g0 >= 0; g0 -= gw)
            v.group(t, k, l, g0, min(gw, nc - g0), gw, l == 0 ? k : g.count(k));
      }
    }
  }
}

// floats of step k's groups in the pack (the groups walk() visits) with a
// head of np parameters
__host__ __device__ inline long long step_floats(const Degrees& g, int k, int np) {
  long long s = 0;
  for (int c0 = 0; c0 < np; c0 += out_cols(np))
    s += group_floats(min(out_cols(np), np - c0), g.count(k));
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
// stage, or one fan-in chunk of a group too large for one. K1 lands a
// piece of whole groups at the stage's start and takes them front first
// (take); K1-bwd, whose walk runs the pack backwards, lands it at the
// stage's end, in pack order, and takes them back first (take_back).
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
  // consumer: the next whole group of `floats` of a reverse walk, in the
  // held piece (below the groups taken from it) or at the next one's end
  __device__ __forceinline__ const float* take_back(int floats) {
    if (held && used + floats <= SL) {
      used += floats;
      return stage + slot * SL + SL - used;
    }
    const float* st = acquire();
    held = true;
    used = floats;
    return st + SL - floats;
  }
  // producer: the stage for the next piece, once every consumer left it
  __device__ __forceinline__ float* fill_begin() const {
    if (wrapped) mbar_wait(empty + slot, phase ^ 1u);
    return stage + slot * SL;
  }
};

// The state K1's save instances write for K1-bwd, in the walk's terms:
// px (T, n, d, np + 1): at transform t, row and step k, the head's np raw
// parameters of dimension inv_order[t, k], then its data value x (the
// inverse's output at that step); signs (T, n, 3, sign_words(h)): the
// signs (> 0) of the three hidden layers' pre-activations, bit s of word
// s / 32 for the unit at place s of the degree-sorted order.
struct SavedState {
  float* px;
  unsigned* signs;
};

__host__ __device__ __forceinline__ int sign_words(int h) { return (h + 31) / 32; }

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

}  // namespace k1
}  // namespace pocomc
