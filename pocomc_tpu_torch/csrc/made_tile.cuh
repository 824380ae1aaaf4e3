// Device code of K2's forward kernel (made_rqs_forward.cu): the weights of
// every transform streamed through a two-stage ring in shared memory with
// cp.async, the register-tiled product of a particle tile with a staged
// weight chunk, and its store epilogue. K5 (coupling_tile.cuh) and the
// backward kernels of both stacks (stack_backward.cuh) take from here
// Saved, the layer inputs a forward saves, the block size and the
// shared-memory limit.
//
// A network is four layers K_0 -> h -> h -> h -> N_3 a transform: the
// masked MADE of an autoregressive transform (Made: K_0 = d, N_3 = d*NP);
// NP is the head's raw parameters a dimension (heads.cuh).
// A chunk is all K rows of a layer's (K, N) weight and nc of its columns,
// plus those columns' biases; it lands in a ring stage as a dense (K, nc)
// block followed by the nc biases. Where a chunk is a whole layer (every
// layer at d=10) its weights are one contiguous block of device memory,
// copied 16 bytes a thread-instruction. The stream walks a fixed schedule
// of (transform, layer) steps and loads chunk i+2 while the block computes
// on chunk i. The output layer's columns are cut into groups of G whole
// dimensions (gw = G*NP columns), so a block holds one group's head
// parameters at a time and its shared memory grows with d + h, not with
// d*NP: at d=10 (h=32) a layer and the whole output layer are one chunk
// each and a transform's four layers (38.9 KB with the spline head) pass
// through the ring one after another. At d=50 (h=256, 1.75 MB a
// transform) the layers run in chunks of 59-86 columns; the output layer
// is one group of all 50 dimensions.
#pragma once

#include <cuda_runtime.h>

#include "heads.cuh"

namespace pocomc {

constexpr int THREADS = 256;  // threads per block of both K2 kernels

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// count contiguous floats, 16 bytes at a time where both ends allow it
__device__ __forceinline__ void copy_flat(float* dst, const float* src, int count) {
  int done = 0;
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) == 0) {
    done = count & ~3;
    for (int v = 4 * threadIdx.x; v < done; v += 4 * THREADS) cp_async16(dst + v, src + v);
  }
  for (int i = done + threadIdx.x; i < count; i += THREADS) cp_async4(dst + i, src + i);
}

// every group but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The ring's first float in a block's dynamic shared memory (declared
// __align__(16)), after `used` floats of tile state: a 16-byte boundary.
__device__ __forceinline__ float* ring_start(float* smem, int used) {
  return smem + ((used + 3) & ~3);
}

// The four masked layers d -> h -> h -> h -> d*np of all T transforms of
// a MADE stack: w[l] is (T, K_l, N_l) and b[l] is (T, N_l), row-major fp32.
struct Made {
  const float* w[4];
  const float* b[4];
  int d, h, T, np;
  __device__ __forceinline__ int fan_in(int, int l) const { return l == 0 ? d : h; }
  __device__ __forceinline__ int fan_out(int, int l) const { return l == 3 ? d * np : h; }
  __device__ __forceinline__ const float* weights(int t, int l) const {
    return w[l] + (size_t)t * fan_in(t, l) * fan_out(t, l);
  }
  __device__ __forceinline__ const float* biases(int t, int l) const {
    return b[l] + (size_t)t * fan_out(t, l);
  }
};

// The input of every layer's product in every transform, (T, n, K_l): the
// transform's input x_t, then relu(h0), relu(h1), relu(h2). The forward
// writes them when asked to, the backward reads them, and the weight
// gradients are their products with the layers' deltas.
struct Saved {
  float* a[4];
};

// One chunk of the schedule: columns [c0, c0 + nc) of layer l of
// transform t, in the column group [g0, gend).
struct Chunk {
  int t, l, c0, nc, g0, gend;
  bool group_end;  // last chunk of its group
  bool layer_end;  // last chunk of the layer
};

// a place in the schedule: the step (transform, layer), the chunk's first
// column and its group's first column
struct Cursor {
  int step, c0, g0;
};

// The two-stage weight ring over the layers of a Made stack.
// Every thread of the block holds the same state and calls the same
// methods in the same order. The loader's cursor runs two chunks ahead of
// the consumer's; both walk the same schedule: transforms 0..T-1 and
// layers 0..3.
struct WeightStream {
  Made m;
  float* stage;   // 2 * SL floats of shared memory from ring_start
  int SL;         // floats per stage, a multiple of 4, at least h + 1
  int gw;         // columns of an output-layer group
  int nsteps, slot;
  Cursor ld, use;

  __device__ WeightStream(const Made& net, float* ring, int sl, int group)
      : m(net), stage(ring), SL(sl), gw(group), nsteps(4 * net.T), slot(0), ld{0, 0, 0},
        use{0, 0, 0} {}

  __device__ __forceinline__ int group_width(int t, int l) const {
    return l == 3 ? gw : m.fan_out(t, l);
  }
  // columns of one chunk of layer l: as many as fit a stage, within a group
  __device__ __forceinline__ int width(int t, int l) const {
    return min(SL / (m.fan_in(t, l) + 1), group_width(t, l));
  }
  // the chunk at *cur, and *cur moved on to the next one
  __device__ __forceinline__ Chunk next(Cursor* cur) const {
    Chunk c;
    c.t = cur->step >> 2;
    c.l = cur->step & 3;
    const int N = m.fan_out(c.t, c.l);
    c.c0 = cur->c0;
    c.g0 = cur->g0;
    c.gend = min(c.g0 + group_width(c.t, c.l), N);
    c.nc = min(width(c.t, c.l), c.gend - c.c0);
    c.group_end = c.c0 + c.nc == c.gend;
    c.layer_end = c.group_end && c.gend == N;
    if (!c.group_end) {
      cur->c0 += c.nc;
    } else {
      cur->c0 = cur->g0 = c.layer_end ? 0 : c.gend;
      cur->step += c.layer_end;
    }
    return c;
  }
  // start copying the next chunk of the schedule into dst (nothing past its
  // end), and commit one cp.async group either way
  __device__ __forceinline__ void load_next(float* dst) {
    if (ld.step < nsteps) {
      const Chunk c = next(&ld);
      const int K = m.fan_in(c.t, c.l), N = m.fan_out(c.t, c.l);
      const float* W = m.weights(c.t, c.l) + c.c0;
      if (c.nc == N) {
        copy_flat(dst, W, K * N);
      } else {
        for (int idx = threadIdx.x; idx < K * c.nc; idx += THREADS) {
          const int k = idx / c.nc, j = idx - k * c.nc;
          cp_async4(dst + idx, W + (size_t)k * N + j);
        }
      }
      const float* bias = m.biases(c.t, c.l) + c.c0;
      for (int j = threadIdx.x; j < c.nc; j += THREADS) cp_async4(dst + K * c.nc + j, bias + j);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void start() {
    load_next(stage);
    load_next(stage + SL);
  }
  // the stage holding the next chunk of the schedule, once it has landed,
  // and its description in *c (worked out while the copy is in flight)
  __device__ __forceinline__ const float* acquire(Chunk* c) {
    *c = next(&use);
    cp_async_wait_prev();
    __syncthreads();
    return stage + slot * SL;
  }
  // done with the current chunk: reuse its stage for the chunk two ahead
  __device__ __forceinline__ void release() {
    __syncthreads();
    load_next(stage + slot * SL);
    slot ^= 1;
  }
};

// The store epilogue of a product: out[p, col - col0] = v, or base[p, col]
// + v where base is set (a residual layer); where act is set, relu of it
// also goes to row row0 + p of act (rows < n only), a Saved activation.
struct Out {
  float* out;
  const float* base;
  float* act;
  int ld, col0, row0, n;
  __device__ void operator()(int p, int col, float v) const {
    const float o = base != nullptr ? base[p * ld + col] + v : v;
    out[p * ld + col - col0] = o;
    if (act != nullptr && row0 + p < n) act[(size_t)(row0 + p) * ld + col] = fmaxf(o, 0.0f);
  }
};

// out[p, c0 + j] = epi(p, c0 + j, sum_k act(in[p, k]) * Ws[k, j] + bias[j])
// for the P rows of the tile and the nc columns of a staged chunk; act is
// ReLU when RELU. Each thread owns RP rows of one column, so one weight
// read from shared memory feeds RP FMAs; the activations are broadcast
// reads. Sums run over k in order with fmaf, then add the bias.
template <int RP, bool RELU, class Epi>
__device__ __forceinline__ void tile_product(const float* in, int ldi, int K, const float* Ws,
                                             int nc, int c0, int P, Epi epi) {
  // the chunk lies in the ring: read it with LDS, not generic loads
  __builtin_assume(__isShared(Ws));
  const float* bias = Ws + K * nc;
  const int items = (P / RP) * nc;
  for (int item = threadIdx.x; item < items; item += THREADS) {
    const int rg = item / nc, j = item - rg * nc;
    const float* a = in + rg * RP * ldi;
    float acc[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float w = Ws[k * nc + j];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        float v = a[r * ldi + k];
        if (RELU) v = fmaxf(v, 0.0f);
        acc[r] = fmaf(v, w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) epi(rg * RP + r, c0 + j, acc[r] + bias[j]);
  }
}

// largest dynamic shared memory a block may ask for on Hopper
constexpr int MAX_SMEM_BYTES = 227 * 1024;

// the launch checks K2's forward makes: the tile (1-16 rows, RP of the
// kernel divides it), G whole dimensions a group, and a ring stage of at
// least one column of every layer
__host__ __forceinline__ bool k2_args_ok(int P, int G, int SL, int d, int h, size_t smem) {
  return smem <= (size_t)MAX_SMEM_BYTES && P >= 1 && P <= 16 && (P & (P - 1)) == 0 &&
         G >= 1 && G <= d && SL >= h + 1 && SL >= d + 1 && SL % 4 == 0;
}

}  // namespace pocomc
