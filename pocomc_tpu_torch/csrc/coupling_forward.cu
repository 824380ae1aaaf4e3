// K5 forward and inverse: a whole stack of T coupling spline transforms
// (the nsfc* flows, models/coupling.py) in one launch, in either
// direction, with the summed log-det.
//
// Replaces no Pallas kernel: the JAX package computes coupling transforms
// as XLA code (pocomc_tpu/models/coupling.py coupling_forward and
// coupling_inverse, the loop over transforms in models/flow.py). A coupling
// transform conditions a residual MLP on one half of the dimensions and
// maps the other half through rational-quadratic splines (BINS bins, one
// library a bins up to 16, one of run-time bins past that: rqs.cuh) whose
// parameters the MLP gives, so both directions are one pass a transform:
// data -> latent runs transforms 0..T-1 with the spline forward, latent ->
// data runs T-1..0 with the spline inverse.
//
// What bounds it on the H100: fp32 FMAs of the four dense products,
// 2 * T * (n_cond*h + 2*h*h + h*NP*n_trans) flops a row (70,656 at nsfc6, 8 bins,
// d=10, h=32; 284,672 multiply-adds a transform at d=50, h=256: 4.5e11
// flops, 6.7 ms at the 67 TFLOP/s fp32 peak, for 12 transforms and 65,536
// rows). At the sweep's n=256-4096 and d=10 a launch is latency: T
// transforms of four dependent products and a spline each.
//
// Design: register-tiled outer products (coupling_tile.cuh). A block of
// 8 consumer warps owns BM rows (8*RM on a Tile, RM on a Row) and runs all
// T transforms on them; the rows, the hidden state and one output group's
// head parameters sit in shared memory k-major. Up to h = 512 a hidden
// layer is one pass over all its h columns (each thread an RM x RNH tile),
// so a residual layer writes h + relu(h) W + b back into the one hidden
// buffer after a barrier (the last one writes relu of it, the output
// layer's input); a wider one runs in passes of columns into a second
// hidden buffer, and the two swap. The output layer runs a group of
// G whole transformed dimensions a pass (RM x RNO tiles), its head
// parameters go to a staging buffer, and the group's BM*G splines run one
// (row, dimension) a thread, writing the transformed columns in place; the
// conditioning columns are never written, so they pass through bit for
// bit. A producer warp streams the weights through coupling_tile.cuh's
// ring in slabs of BK rows, in the walk's order of transforms, each
// transform's weights its own tensors, read through a device table of 8T
// pointers (the output layers from the wrapper's packed copy).
// With `sv` set it also writes every layer's input of every transform,
// (T, n, d) x_t and (T, n, h) relu(h0..h2): in the forward, what the
// backward kernel (coupling_backward.cu) and the weight-gradient products
// take; in the inverse (its save instance), the state of K5-inv-bwd, x_t
// being the transform's data-side value after its splines (the inverse's
// own intermediate; the conditioning columns pass through, so relu(h0..h2)
// equal a forward's at x value for value), with, at `ps`, the output
// layer's spline parameters (T, n, ceil(d/2)*NP), so that the gradient
// neither runs K5's forward nor recomputes the output layer's product.
// The instances without the save compute the same values in the same
// order. fp32 FMAs only: no tensor cores, no fast-math.
#include <cuda_runtime.h>

#include "coupling_tile.cuh"

namespace {

using namespace pocomc;
using k5::NP;
using k5::Vec;
using k5::col_of;
using k5::row_of;

// o = [Hin[col][row] +] (acc + bias[col]) for the thread's tile, columns <
// w, to Hout[col][row], or relu(o) where relu_out (the output layer's
// input, which nothing else reads); where act is set, relu(o) also goes to
// act (row-major, row stride ld, rows < n), 16 bytes a store where the row
// allows it. Hin and Hout may be one buffer (the thread's own elements).
template <int RM, int RN, int BMP, class Ln>
__device__ __forceinline__ void hidden_epilogue(float (&acc)[RM][RN], const float* Hin,
                                                float* Hout, const float* __restrict__ bias,
                                                int w, bool residual, bool relu_out, float* act,
                                                int ld, int row0, int n, const Ln& L) {
  using CR = Vec<RM>;
  using CC = Vec<RN>;
#pragma unroll
  for (int ci = 0; ci < CC::N; ++ci)
#pragma unroll
    for (int cj = 0; cj < CC::W; ++cj) {
      const int col = col_of<RN>(L, ci) + cj, c = ci * CC::W + cj;
      if (col >= w) continue;
      const float b = __ldg(bias + col);
#pragma unroll
      for (int ri = 0; ri < CR::N; ++ri) {
        const int at = col * BMP + row_of<RM>(L, ri);
        float base[CR::W], o[CR::W];
        if (residual) k5::load_vec<CR::W>(Hin + at, base);
#pragma unroll
        for (int rj = 0; rj < CR::W; ++rj) {
          const float v = acc[ri * CR::W + rj][c] + b;
          o[rj] = residual ? base[rj] + v : v;
          acc[ri * CR::W + rj][c] = o[rj];
          if (relu_out) o[rj] = fmaxf(o[rj], 0.0f);
        }
        k5::store_vec<CR::W>(Hout + at, o);
      }
    }
  if (act != nullptr) k5::store_rows<RM, RN, true>(acc, act, ld, w, row0, n, L);
}

template <bool INVERSE, class Ln, int RM, int RNH, int RNO>
__global__ void __launch_bounds__(k5::BLOCK, 1)
    coupling_kernel(const float* __restrict__ xin, float* __restrict__ xout,
                    float* __restrict__ ladj, Saved sv, float* __restrict__ ps, int n,
                    k5::Coupling m, k5::Packed pk, int G, int BK, int S) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = Ln::rows(RM), BMP = Ln::stride(RM);
  using CR = Vec<RM>;
  using CO = Vec<RNO>;
  const int d = m.d, h = m.h;
  const int nh = k5::multi_pass<Ln, RNH>() ? (h + Ln::cols(RNH) - 1) / Ln::cols(RNH) : 1;
  float* X = smem;                       // [d][BMP]      the rows, transformed in place
  float* H = X + d * BMP;                // [h][BMP]      hidden state
  float* H2 = nh > 1 ? H + h * BMP : H;  // [h][BMP]      a residual layer's output (nh > 1)
  const int np = RqsHead::RUNTIME ? m.np : NP;  // raw parameters a transformed dimension
  float* P = H + (nh > 1 ? 2 : 1) * h * BMP;  // [G*np][BMP]  one output group's head parameters
  float* LG = P + G * np * BMP;          // [half][BMP]   per-dimension log-dets
  float* LS = LG + m.half() * BMP;       // [BM]          log-det accumulator
  k5::Ring ring =
      k5::make_ring(k5::Plan{m, G, BK, Ln::cols(RNH), false, INVERSE, pk, false, Ln::cols(RNO)},
                    smem, (LS + BM) - smem, S, BK, Ln::cols(RNH), Ln::cols(RNO));
  if (threadIdx.x >= THREADS) {
    k5::produce(ring);
    return;
  }
  const k5::Plan& plan = ring.pl;
  const Ln L;
  const bool save = sv.a[0] != nullptr;

  const int row0 = blockIdx.x * BM;
  for (int idx = threadIdx.x; idx < BM * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    X[c * BMP + r] = row0 + r < n ? xin[(size_t)(row0 + r) * d + c] : 0.0f;
  }
  for (int r = threadIdx.x; r < BM; r += THREADS) LS[r] = 0.0f;
  k5::consumer_sync();

  for (int i = 0; i < m.T; ++i) {
    const int t = plan.transform(i);
    const int c0 = m.cond0(t), tr0 = m.trans0(t), ntr = m.n_trans(t);
    const size_t off = (size_t)t * n;
    if (save && !INVERSE) {
      for (int idx = threadIdx.x; idx < BM * d; idx += THREADS) {
        const int r = idx / d, c = idx - r * d;
        if (row0 + r < n) sv.a[0][(off + row0 + r) * d + c] = X[c * BMP + r];
      }
    }
    // -- layer 0 on the conditioning columns, then the two residual layers,
    //    each nh passes of columns; with one pass a residual layer updates
    //    H in place, with several it writes H2 and the two swap
    for (int l = 0; l < 3; ++l) {
      float* out = l == 0 || nh == 1 ? H : H2;
      for (int c = 0; c < nh; ++c) {
        const k5::Pass q = plan.pass(t, l * nh + c, nh);
        float acc[RM][RNH];
        k5::zero(acc);
        if (l == 0) {
          k5::run_pass<RM, RNH, false>(acc, ring, q, X + c0 * BMP, BMP, L);
        } else {
          k5::run_pass<RM, RNH, true>(acc, ring, q, H, BMP, L);
          if (nh == 1) k5::consumer_sync();  // every thread has read H: update it in place
        }
        hidden_epilogue<RM, RNH, BMP>(acc, H + q.o0 * BMP, out + q.o0 * BMP,
                                      m.biases(t, l) + q.o0, q.no, l > 0, l == 2,
                                      save ? sv.a[l + 1] + off * h + q.o0 : nullptr, h, row0,
                                      n, L);
      }
      if (out != H) {
        H2 = H;
        H = out;
      }
      k5::consumer_sync();
    }
    // -- the output layer, a group of whole transformed dimensions a pass
    //    (or, with the spline of run-time bins, a group of one dimension in
    //    plan.subs() passes), each group's splines right after it
    const float* b3 = m.biases(t, 3);
    const int subs = plan.subs();
    for (int g = 0; g < plan.groups(t); ++g) {
      int go = 0, gn = 0;  // the group's first column and its width
      for (int j = 0; j < subs; ++j) {
        const k5::Pass q = plan.pass(t, 3 * nh + g * subs + j, nh);
        if (j == 0) go = q.o0;
        gn = q.o0 + q.no - go;
        float* Pq = P + (q.o0 - go) * BMP;
        float acc[RM][RNO];
        k5::zero(acc);
        k5::run_pass<RM, RNO, false>(acc, ring, q, H, BMP, L);
#pragma unroll
        for (int ci = 0; ci < CO::N; ++ci)
#pragma unroll
          for (int cj = 0; cj < CO::W; ++cj) {
            const int col = col_of<RNO>(L, ci) + cj;
            if (col >= q.no) continue;
            const float b = __ldg(b3 + q.o0 + col);
#pragma unroll
            for (int ri = 0; ri < CR::N; ++ri) {
              float o[CR::W];
#pragma unroll
              for (int rj = 0; rj < CR::W; ++rj) {
                float& a = acc[ri * CR::W + rj][ci * CO::W + cj];
                a = a + b;
                o[rj] = a;
              }
              k5::store_vec<CR::W>(Pq + col * BMP + row_of<RM>(L, ri), o);
            }
          }
        if (ps != nullptr) {
          const int lp = m.half() * np;
          k5::store_rows<RM, RNO, false>(acc, ps + off * lp + q.o0, lp, q.no, row0, n, L);
        }
      }
      k5::consumer_sync();
      const int k0 = go / np, gd = gn / np;
      for (int idx = threadIdx.x; idx < BM * gd; idx += THREADS) {
        const int r = idx % BM, k = idx / BM;
        float* x = X + (tr0 + k0 + k) * BMP + r;
        float lg;
#if POCOMC_RUNTIME_BINS
        const ParamsAt<BMP> p{P + k * np * BMP + r};
        const int bins = (np + 1) / 3;
        *x = INVERSE ? RqsHead::inverse(*x, p, bins, &lg) : RqsHead::forward(*x, p, bins, &lg);
#else
        float p[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) p[j] = P[(k * NP + j) * BMP + r];
        *x = INVERSE ? RqsHead::inverse(*x, p, &lg) : RqsHead::forward(*x, p, &lg);
#endif
        LG[(k0 + k) * BMP + r] = lg;
      }
      k5::consumer_sync();  // the splines are done with P, X and LG
    }
    if (save && INVERSE) {
      for (int idx = threadIdx.x; idx < BM * d; idx += THREADS) {
        const int r = idx / d, c = idx - r * d;
        if (row0 + r < n) sv.a[0][(off + row0 + r) * d + c] = X[c * BMP + r];
      }
      // at odd d a transform of half - 1 dimensions leaves its last NP
      // parameter columns zero, as the plain layout has them
      const int lp = m.half() * np, pad = lp - ntr * np;
      for (int idx = threadIdx.x; idx < BM * pad; idx += THREADS) {
        const int r = idx / pad, c = lp - pad + idx % pad;
        if (row0 + r < n) ps[(off + row0 + r) * lp + c] = 0.0f;
      }
    }
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      float s = 0.0f;
      for (int k = 0; k < ntr; ++k) s += LG[k * BMP + r];
      LS[r] += s;
    }
  }
  k5::consumer_sync();

  for (int idx = threadIdx.x; idx < BM * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    if (row0 + r < n) xout[(size_t)(row0 + r) * d + c] = X[c * BMP + r];
  }
  for (int r = threadIdx.x; r < BM; r += THREADS)
    if (row0 + r < n) ladj[row0 + r] = LS[r];
}

struct Args {
  const float* xin;
  float* xout;
  float* ladj;
  Saved sv;
  float* ps;
  int n;
  k5::Coupling m;
  k5::Packed pk;
  int G, BK, S;
  size_t smem;
  cudaStream_t stream;
};

template <bool INVERSE, class Ln, int RM, int RNH, int RNO>
int launch(const Args& a) {
  auto kernel = coupling_kernel<INVERSE, Ln, RM, RNH, RNO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BM = Ln::rows(RM);
  kernel<<<(a.n + BM - 1) / BM, k5::BLOCK, a.smem, a.stream>>>(
      a.xin, a.xout, a.ladj, a.sv, a.ps, a.n, a.m, a.pk, a.G, a.BK, a.S);
  return (int)cudaGetLastError();
}

// the compiled Tile instances: RM in {1, 2, 4, 8} with RM * max(RNH, RNO)
// <= 64
template <bool INVERSE, int RNH, int RNO>
int by_rows(int RM, const Args& a) {
  using k5::Tile;
  constexpr int RN = RNH > RNO ? RNH : RNO;
  switch (RM) {
    case 1: return launch<INVERSE, Tile, 1, RNH, RNO>(a);
    case 2: return launch<INVERSE, Tile, 2, RNH, RNO>(a);
    case 4: return launch<INVERSE, Tile, 4, RNH, RNO>(a);
    case 8:
      if constexpr (8 * RN <= 64) return launch<INVERSE, Tile, 8, RNH, RNO>(a);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// the compiled Row instances: RM in {1, 2, 4}, RNH 2 and RNO 1 (passes of
// 512 hidden and 256 output columns)
template <bool INVERSE>
int by_row_tile(int RM, int RNH, int RNO, const Args& a) {
  using k5::Row;
  if (RNH != 2 || RNO != 1) return (int)cudaErrorInvalidValue;
  switch (RM) {
    case 1: return launch<INVERSE, Row, 1, 2, 1>(a);
    case 2: return launch<INVERSE, Row, 2, 2, 1>(a);
    case 4: return launch<INVERSE, Row, 4, 2, 1>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool INVERSE>
int by_tile(int RL, int BM, int RNH, int RNO, const Args& a) {
  if (RL == 1) return by_row_tile<INVERSE>(BM, RNH, RNO, a);
  const int RM = BM / 8;
  if (RNH == 1 && RNO == 4) return by_rows<INVERSE, 1, 4>(RM, a);
  if (RNH == 2 && RNO == 8) return by_rows<INVERSE, 2, 8>(RM, a);
  if (RNH == 4 && RNO == 8) return by_rows<INVERSE, 4, 8>(RM, a);
  if (RNH == 8 && RNO == 8) return by_rows<INVERSE, 8, 8>(RM, a);
  if (RNH == 16 && RNO == 8) return by_rows<INVERSE, 16, 8>(RM, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// shared-memory floats of one block with np raw parameters a transformed
// dimension: the rows, the hidden state (twice where a hidden layer takes
// several passes), one output group's parameters and the per-dimension
// log-dets, each [.][BMP], the log-det accumulator and the S-stage ring
extern "C" int coupling_forward_smem_floats(int RL, int BM, int RNH, int RNO, int G, int BK,
                                            int S, int d, int h, int np) {
  const int bmp = RL == 4 ? BM + 4 : BM, cl = RL == 4 ? 32 : 256;
  const int hidden = h > cl * RNH ? 2 * h : h;
  return bmp * (d + hidden + G * np + (d + 1) / 2) + BM +
         pocomc::k5::ring_floats(S, BK, cl * RNH, cl * RNO);
}

// Plain C entry point, loaded with ctypes. table holds the 8T device
// pointers of the T coupling transforms' fp32 weights and biases (w0 b0
// w1 b1 w2 b2 w3 b3 of each; w0 (n_cond_t, h), w3 (h, n_trans_t*NP), the
// halves of make_coupling_masks; every pointer 16-byte aligned). inverse =
// 0 maps data -> latent through transforms 0..T-1 (the spline forward,
// ladj = log|dz/dx|), 1 latent -> data through T-1..0 (ladj = log|dx/dz|).
// a0..a3 are all null, or receive the input of every layer's product:
// a0 (T, n, d) the transform inputs (the inverse: each transform's output
// of the inverse, its x_t), a1..a3 (T, n, h) relu(h0), relu(h1),
// relu(h2); ap (given with a0 in the inverse, else null) receives the
// output layers' spline parameters (T, n, ceil(d/2)*NP), zero past a
// transform's own. The tile: RL = 4 a Tile of BM rows a block
// (8, 16, 32, 64), passes of 32*RNH hidden and 32*RNO output columns, or RL
// = 1 a Row of BM = 1, 2 or 4 rows, passes of 256*RNH and 256*RNO; an
// output group of G whole transformed dimensions (G*NP columns, at most an
// output pass; with the spline of run-time bins G = 1 and any NP), slabs of
// BK weight rows in an S-stage ring. w3 holds the output layers packed as
// coupling_tile.cuh Packed describes ((T, ceil(ceil(d/2)/G), h, output pass
// width), 16-byte aligned). np is the spline's raw parameters a dimension,
// 3 bins - 1 (the library's bins, or any with run-time bins). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int coupling_forward_launch(const float* xin, float* xout, float* ladj, int n, int d,
                                       int h, int T, const float* const* table, const float* w3,
                                       float* a0, float* a1, float* a2, float* a3, float* ap,
                                       int inverse, int RL, int BM, int RNH, int RNO, int G,
                                       int BK, int S, int np, int device, void* stream) {
  if (w3 == nullptr || (ap != nullptr) != (inverse && a0 != nullptr) ||
      !pocomc::head_compiled(np) || np == pocomc::AffineHead::NP)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * (size_t)coupling_forward_smem_floats(RL, BM, RNH, RNO, G, BK, S, d, h, np);
  pocomc::k5::Coupling m{table, d, h, T};
  m.np = np;
  if (!pocomc::k5::k5_args_ok(RL, BM, RNH, RNO, G, BK, S, m, smem))
    return (int)cudaErrorInvalidValue;
  const Args a{xin, xout, ladj, pocomc::Saved{{a0, a1, a2, a3}}, ap, n, m,
               pocomc::k5::Packed{w3, nullptr, ((d + 1) / 2 + G - 1) / G}, G, BK, S, smem,
               (cudaStream_t)stream};
  if (inverse) return by_tile<true>(RL, BM, RNH, RNO, a);
  return by_tile<false>(RL, BM, RNH, RNO, a);
}
