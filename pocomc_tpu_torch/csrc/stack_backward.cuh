// The backward kernel of a stack of T transforms whose networks are four
// layers K_0 -> h -> h -> h -> n_trans*NP (input, two residual layers,
// output to the head's parameters), shared by K5's backward and inverse
// backward (coupling_backward.cu, the coupling stacks of the nsfc* flows)
// and by K2's backward (made_rqs_backward.cu, the masked autoregressive
// stacks of the nsf* and maf* flows, whose masked weights it takes as
// dense). The network is a coupling_tile.cuh Coupling: halves of a
// coupling stack, or every dimension of a MADE stack (made()).
//
// Design: the register tiles and weight ring of coupling_tile.cuh. A
// block of 8 consumer warps owns BM rows (8*RM on a Tile, RM on a Row; a
// producer warp streams the weights, the output layer and every W^T from
// the wrapper's packed copies, every slab one bulk copy) and walks the
// transforms in reverse, reading the layer inputs the forward kernel
// saved, k-major. The output layer runs a group of G whole transformed
// dimensions at a time (as many as an output pass holds): the group's head
// parameters from relu(h2) (an RM x RNO tile a thread, the forward's sum
// order), the head's VJP of its BM*G (row, dim) pairs (heads.cuh
// forward_vjp, one thread each), then their gradients through W3^T into an
// RM x RNH accumulator that stays in registers across the groups (where h
// is wider than a pass, h > 512, a pass of columns at a time into a second
// hidden buffer, each column's sum in the same order). Then delta W^T back
// through the residual layers and the input layer, whose fan-in is the
// conditioning columns: dL/dx_t of a conditioning column is the net's
// gradient plus what it held, of a transformed column the head's own. A
// coupling transform's columns are one or the other; a MADE transform's
// are both, so the head's VJP writes every column and the input layer adds
// the net's gradient to each. A product with W^T stages each slab of W
// transposed and sums j, its contraction index, in ascending order.
// Barriers among the consumer warps only where one warp's writes meet
// another's reads: around the in-place updates (or the swap of the two
// hidden buffers), the staging buffer and the head's VJP.
// The deltas of the four layers go to scratch (T, n, .), rows < n only,
// the output layer's at the widest transformed part (wide()*NP columns,
// the columns a narrower half leaves set to 0); the wrapper takes the
// weight gradients from them and the saved activations with batched
// products and row sums over T, so no float atomics sit on the gradient
// path and every run gives the same bits. fp32 FMAs only.
//
// The inverse instances (INV, K5-inv-bwd) walk the same schedule with the
// same tiles on the state K5's inverse saved (its save instance,
// coupling_forward.cu): each transform's x_t (the inverse's own
// intermediate), relu(h0..h2) and, where given (ps), the output layer's
// head parameters, which then replace the output layer's product (Plan
// psaved: no such pass). Transforms go 0..T-1 (the inverse ran T-1..0),
// and the element step is the inverse's VJP (heads.cuh inverse_vjp: g_z of
// the transformed column from dL/dx, and the parameters' cotangent); the
// conditioning columns take the same pass-through plus the net's gradient.
// They write no deltas: the JAX package never differentiates the inverse
// in the weights.
#pragma once

#include <cuda_runtime.h>

#include "coupling_tile.cuh"

namespace pocomc {
namespace stack {

using k5::Vec;
using k5::col_of;
using k5::row_of;

// each layer's output delta g[l] (T, n, N_l), the output layer's at the
// row width ldo (wide()*NP; also the row width of the saved parameters)
struct Deltas {
  float* g[4];
  int ldo;
};

// [k][row] <- the block's rows of a row-major (n, w) array of row stride
// ld (0 past n)
template <int BM, int BMP>
__device__ __forceinline__ void load_k_major(float* dst, const float* src, int w, int ld,
                                             int row0, int n) {
  for (int idx = threadIdx.x; idx < BM * w; idx += THREADS) {
    const int r = idx / w, c = idx - r * w;
    dst[c * BMP + r] = row0 + r < n ? src[(size_t)(row0 + r) * ld + c] : 0.0f;
  }
}

template <class Head, class Ln, int RM, int RNH, int RNO, bool INV>
__global__ void __launch_bounds__(k5::BLOCK, 1)
    backward_kernel(Saved sv, const float* __restrict__ ps, const float* __restrict__ gz,
                    const float* __restrict__ gladj, float* __restrict__ gy, Deltas dl, int n,
                    k5::Coupling m, k5::Packed pk, int G, int BK, int S) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = Ln::rows(RM), BMP = Ln::stride(RM);
  const int NP = Head::RUNTIME ? m.np : Head::NP;  // raw parameters a transformed dimension
  using CR = Vec<RM>;
  using CH = Vec<RNH>;
  using CO = Vec<RNO>;
  const int d = m.d, h = m.h;
  const int nh = k5::multi_pass<Ln, RNH>() ? (h + Ln::cols(RNH) - 1) / Ln::cols(RNH) : 1;
  float* X = smem;                         // [d][BMP]     the transform's input x_t
  float* AG = X + d * BMP;                 // [h][BMP]     relu(h2), then dL/dh of the layer
  float* B2 = nh > 1 ? AG + h * BMP : AG;  // [h][BMP]     g W3^T, then the next dL/dh (nh > 1)
  float* P = AG + (nh > 1 ? 2 : 1) * h * BMP;  // [G*NP][BMP]  one group's head parameters,
                                               //              then their gradients
  float* GX = P + G * NP * BMP;            // [d][BMP]     dL/dx_{t+1}, then dL/dx_t
  float* GL = GX + d * BMP;                // [BM]         dL/dladj
  k5::Plan pl{m, G, BK, Ln::cols(RNH), true, !INV, pk};
  pl.psaved = INV && ps != nullptr;
  pl.OW = Ln::cols(RNO);
  k5::Ring ring = k5::make_ring(pl, smem, (GL + BM) - smem, S, BK, Ln::cols(RNH),
                                Ln::cols(RNO));
  if (threadIdx.x >= THREADS) {
    k5::produce(ring);
    return;
  }
  const k5::Plan& plan = ring.pl;
  const Ln L;
  // an output group's product takes subs passes (one but with the spline
  // of run-time bins), then its gradient nh passes through W3^T
  const int per = plan.per(nh), subs = plan.subs(), first_t = plan.psaved ? 0 : subs;

  const int row0 = blockIdx.x * BM;
  load_k_major<BM, BMP>(GX, gz, d, d, row0, n);
  for (int r = threadIdx.x; r < BM; r += THREADS) GL[r] = row0 + r < n ? gladj[row0 + r] : 0.0f;

  for (int i = 0; i < m.T; ++i) {
    const int t = plan.transform(i);
    const int c0 = m.cond0(t), tr0 = m.trans0(t);
    const int dout = m.n_trans(t) * NP, ng = plan.groups(t);
    const size_t off = (size_t)t * n;
    k5::consumer_sync();  // the transform before is done with X and AG
    load_k_major<BM, BMP>(X, sv.a[0] + off * d, d, d, row0, n);
    load_k_major<BM, BMP>(AG, sv.a[3] + off * h, h, h, row0, n);
    k5::consumer_sync();
    // the output delta's columns past this transform's half stay 0
    for (int idx = threadIdx.x; !INV && idx < BM * (dl.ldo - dout); idx += THREADS) {
      const int p = idx / (dl.ldo - dout), j = dout + idx - p * (dl.ldo - dout);
      if (row0 + p < n) dl.g[3][(off + row0 + p) * dl.ldo + j] = 0.0f;
    }
    // -- output layer, a group at a time: params = relu(h2) W3 + b3 (or
    //    the saved ones), the head's VJP in place over them, then their
    //    part of g W3^T, summed over the groups in registers (one pass of
    //    h) or, a pass of columns at a time, in B2
    const float* b3 = m.biases(t, 3);
    float gacc[RM][RNH];
    k5::zero(gacc);
    for (int g = 0; g < ng; ++g) {
      const int go = g * G * NP, gn = min(G * NP, dout - go);
      if (plan.psaved) {
        if (g > 0) k5::consumer_sync();  // the group before is done with P
        load_k_major<BM, BMP>(P, ps + off * dl.ldo + go, gn, dl.ldo, row0, n);
      } else {
        for (int j = 0; j < subs; ++j) {
          const k5::Pass q = plan.pass(t, g * per + j, nh);
          float acc[RM][RNO];
          k5::zero(acc);
          k5::run_pass<RM, RNO, false>(acc, ring, q, AG, BMP, L);
          if (g > 0 && j == 0) k5::consumer_sync();  // the group before is done with P
          float* Pq = P + (q.o0 - go) * BMP;
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
                for (int rj = 0; rj < CR::W; ++rj)
                  o[rj] = acc[ri * CR::W + rj][ci * CO::W + cj] + b;
                k5::store_vec<CR::W>(Pq + col * BMP + row_of<RM>(L, ri), o);
              }
            }
        }
      }
      k5::consumer_sync();
      const int k0 = go / NP, gd = gn / NP;
      for (int idx = threadIdx.x; idx < BM * gd; idx += THREADS) {
        const int r = idx % BM, k = idx / BM, col = tr0 + k0 + k;
        float* gx = GX + col * BMP + r;
        if constexpr (Head::RUNTIME) {
          // the head's VJP in place over the group's parameters
          const ParamsAt<BMP> p{P + k * NP * BMP + r};
          const int bins = (NP + 1) / 3;
          if constexpr (INV) {
            *gx = Head::inverse_vjp(X[col * BMP + r], p, p, bins, *gx, GL[r]);
          } else {
            *gx = Head::forward_vjp(X[col * BMP + r], p, p, bins, *gx, GL[r]);
            if (row0 + r < n) {
              float* delta = dl.g[3] + (off + row0 + r) * dl.ldo + go + k * NP;
              for (int j = 0; j < NP; ++j) delta[j] = p[j];
            }
          }
        } else {
          float p[Head::NP];
#pragma unroll
          for (int j = 0; j < NP; ++j) p[j] = P[(k * NP + j) * BMP + r];
          if constexpr (INV) {
            *gx = Head::inverse_vjp(X[col * BMP + r], p, *gx, GL[r]);
#pragma unroll
            for (int j = 0; j < NP; ++j) P[(k * NP + j) * BMP + r] = p[j];
          } else {
            *gx = Head::forward_vjp(X[col * BMP + r], p, *gx, GL[r]);
            float* delta = dl.g[3] + (off + row0 + r) * dl.ldo + go + k * NP;
            const bool real = row0 + r < n;
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              P[(k * NP + j) * BMP + r] = p[j];
              if (real) delta[j] = p[j];
            }
          }
        }
      }
      k5::consumer_sync();
      if (nh == 1) {
        k5::run_pass<RM, RNH, false>(gacc, ring, plan.pass(t, g * per + first_t, nh), P, BMP, L);
      } else {
        for (int c = 0; c < nh; ++c) {
          const k5::Pass qt = plan.pass(t, g * per + first_t + c, nh);
          float acc[RM][RNH];
          if (g == 0) {
            k5::zero(acc);
          } else {
            k5::load_tile<RM, RNH, BMP>(acc, B2 + qt.o0 * BMP, qt.no, L);
          }
          k5::run_pass<RM, RNH, false>(acc, ring, qt, P, BMP, L);
          k5::store_tile<RM, RNH, BMP>(acc, B2 + qt.o0 * BMP, qt.no, L);
        }
      }
    }
    // -- dL/dh2 = (g W3^T) masked by ReLU'(h2), in place over relu(h2)
    auto mask_h2 = [&](float (&acc)[RM][RNH], int o0, int no) {
#pragma unroll
      for (int ci = 0; ci < CH::N; ++ci)
#pragma unroll
        for (int cj = 0; cj < CH::W; ++cj) {
          const int col = col_of<RNH>(L, ci) + cj, c = ci * CH::W + cj;
          if (col >= no) continue;
#pragma unroll
          for (int ri = 0; ri < CR::N; ++ri) {
            float* ap = AG + (o0 + col) * BMP + row_of<RM>(L, ri);
            float a[CR::W];
            k5::load_vec<CR::W>(ap, a);
#pragma unroll
            for (int rj = 0; rj < CR::W; ++rj) {
              a[rj] = a[rj] > 0.0f ? acc[ri * CR::W + rj][c] : 0.0f;
              acc[ri * CR::W + rj][c] = a[rj];
            }
            k5::store_vec<CR::W>(ap, a);
          }
        }
      if constexpr (!INV)
        k5::store_rows<RM, RNH, false>(acc, dl.g[2] + off * h + o0, h, no, row0, n, L);
    };
    if (nh == 1) {
      mask_h2(gacc, 0, h);
    } else {
      for (int c = 0; c < nh; ++c) {
        const int o0 = c * plan.PW, no = min(plan.PW, h - o0);
        float acc[RM][RNH];
        k5::load_tile<RM, RNH, BMP>(acc, B2 + o0 * BMP, no, L);
        mask_h2(acc, o0, no);
      }
    }
    k5::consumer_sync();
    // -- residual layers l = 2, 1: dL/dh_{l-1} = dL/dh_l + (dL/dh_l W_l^T
    //    masked by ReLU'(h_{l-1})), relu(h_{l-1}) being the saved a[l]; in
    //    place over AG with one pass of h, else into B2 and the two swap
    for (int l = 2; l >= 1; --l) {
      float* out = nh == 1 ? AG : B2;
      for (int c = 0; c < nh; ++c) {
        const k5::Pass q = plan.pass(t, ng * per + (2 - l) * nh + c, nh);
        float acc[RM][RNH];
        k5::zero(acc);
        k5::run_pass<RM, RNH, false>(acc, ring, q, AG, BMP, L);
        float a[RM][RNH];
        k5::load_rows<RM, RNH>(a, sv.a[l] + off * h + q.o0, h, q.no, row0, n, L);
        if (nh == 1) k5::consumer_sync();  // every thread has read dL/dh_l: update it in place
#pragma unroll
        for (int ci = 0; ci < CH::N; ++ci)
#pragma unroll
          for (int cj = 0; cj < CH::W; ++cj) {
            const int col = col_of<RNH>(L, ci) + cj, c2 = ci * CH::W + cj;
            if (col >= q.no) continue;
#pragma unroll
            for (int ri = 0; ri < CR::N; ++ri) {
              const int at = (q.o0 + col) * BMP + row_of<RM>(L, ri);
              float v[CR::W];
              k5::load_vec<CR::W>(AG + at, v);
#pragma unroll
              for (int rj = 0; rj < CR::W; ++rj) {
                const int r = ri * CR::W + rj;
                v[rj] = v[rj] + (a[r][c2] > 0.0f ? acc[r][c2] : 0.0f);
                acc[r][c2] = v[rj];
              }
              k5::store_vec<CR::W>(out + at, v);
            }
          }
        if constexpr (!INV)
          k5::store_rows<RM, RNH, false>(acc, dl.g[l - 1] + off * h + q.o0, h, q.no, row0, n,
                                         L);
      }
      if (out != AG) {
        B2 = AG;
        AG = out;
      }
      k5::consumer_sync();
    }
    // -- input layer: the conditioning columns' net gradient dL/dh0 W0^T
    //    plus what they hold (a coupling transform's pass-through, a MADE
    //    transform's head VJP); a coupling transform's transformed columns
    //    hold the head's own since the VJP
    for (int p = ng * per + 2 * nh; p < plan.passes(t, nh); ++p) {
      const k5::Pass q = plan.pass(t, p, nh);
      float acc[RM][RNH];
      k5::zero(acc);
      k5::run_pass<RM, RNH, false>(acc, ring, q, AG, BMP, L);
#pragma unroll
      for (int ci = 0; ci < CH::N; ++ci)
#pragma unroll
        for (int cj = 0; cj < CH::W; ++cj) {
          const int col = col_of<RNH>(L, ci) + cj, c = ci * CH::W + cj;
          if (col >= q.no) continue;
#pragma unroll
          for (int ri = 0; ri < CR::N; ++ri) {
            float* gp = GX + (c0 + q.o0 + col) * BMP + row_of<RM>(L, ri);
            float v[CR::W];
            k5::load_vec<CR::W>(gp, v);
#pragma unroll
            for (int rj = 0; rj < CR::W; ++rj) v[rj] = acc[ri * CR::W + rj][c] + v[rj];
            k5::store_vec<CR::W>(gp, v);
          }
        }
    }
  }
  k5::consumer_sync();
  for (int idx = threadIdx.x; idx < BM * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    if (row0 + r < n) gy[(size_t)(row0 + r) * d + c] = GX[c * BMP + r];
  }
}

struct Args {
  Saved sv;
  const float* ps;
  const float* gz;
  const float* gladj;
  float* gy;
  Deltas dl;
  int n;
  k5::Coupling m;
  k5::Packed pk;
  int G, BK, S;
  bool inverse;
  size_t smem;
  cudaStream_t stream;
};

template <class Head, class Ln, int RM, int RNH, int RNO, bool INV>
int launch_dir(const Args& a) {
  auto kernel = backward_kernel<Head, Ln, RM, RNH, RNO, INV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BM = Ln::rows(RM);
  kernel<<<(a.n + BM - 1) / BM, k5::BLOCK, a.smem, a.stream>>>(
      a.sv, a.ps, a.gz, a.gladj, a.gy, a.dl, a.n, a.m, a.pk, a.G, a.BK, a.S);
  return (int)cudaGetLastError();
}

// the backward's instance of a tile, or the inverse's where WITH_INV
template <class Head, bool WITH_INV, class Ln, int RM, int RNH, int RNO>
int launch(const Args& a) {
  if constexpr (WITH_INV) {
    if (a.inverse) return launch_dir<Head, Ln, RM, RNH, RNO, true>(a);
  }
  if (a.inverse) return (int)cudaErrorInvalidValue;
  return launch_dir<Head, Ln, RM, RNH, RNO, false>(a);
}

// the compiled Tile instances: RM in {1, 2, 4, 8} with RM * (RNH + RNO)
// <= 64, the two accumulators the output layer holds at once
template <class Head, bool WITH_INV, int RNH, int RNO>
int by_rows(int RM, const Args& a) {
  using k5::Tile;
  constexpr int RN = RNH + RNO;
  switch (RM) {
    case 1: return launch<Head, WITH_INV, Tile, 1, RNH, RNO>(a);
    case 2:
      if constexpr (2 * RN <= 64) return launch<Head, WITH_INV, Tile, 2, RNH, RNO>(a);
      break;
    case 4:
      if constexpr (4 * RN <= 64) return launch<Head, WITH_INV, Tile, 4, RNH, RNO>(a);
      break;
    case 8:
      if constexpr (8 * RN <= 64) return launch<Head, WITH_INV, Tile, 8, RNH, RNO>(a);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <class Head, bool WITH_INV>
int by_tile(int RL, int BM, int RNH, int RNO, const Args& a) {
  if (RL == 1) {
    // the compiled Row instances: RM = BM in {1, 2, 4}, RNH 2, RNO 1
    if (RNH != 2 || RNO != 1) return (int)cudaErrorInvalidValue;
    if (BM == 1) return launch<Head, WITH_INV, k5::Row, 1, 2, 1>(a);
    if (BM == 2) return launch<Head, WITH_INV, k5::Row, 2, 2, 1>(a);
    if (BM == 4) return launch<Head, WITH_INV, k5::Row, 4, 2, 1>(a);
    return (int)cudaErrorInvalidValue;
  }
  const int RM = BM / 8;
  if (RNH == 1 && RNO == 4) return by_rows<Head, WITH_INV, 1, 4>(RM, a);
  if (RNH == 2 && RNO == 8) return by_rows<Head, WITH_INV, 2, 8>(RM, a);
  if (RNH == 4 && RNO == 8) return by_rows<Head, WITH_INV, 4, 8>(RM, a);
  if (RNH == 8 && RNO == 8) return by_rows<Head, WITH_INV, 8, 8>(RM, a);
  if (RNH == 16 && RNO == 8) return by_rows<Head, WITH_INV, 16, 8>(RM, a);
  return (int)cudaErrorInvalidValue;
}

// shared-memory floats of one block: the transform's input, relu(h2) (then
// the hidden delta; twice where a hidden layer takes several passes), one
// output group's parameters and the input gradient, each [.][BMP],
// dL/dladj and the S-stage ring
__host__ __forceinline__ int smem_floats(int RL, int BM, int RNH, int RNO, int G, int BK, int S,
                                         int d, int h, int np) {
  const int bmp = RL == 4 ? BM + 4 : BM, cl = RL == 4 ? 32 : 256;
  const int hidden = h > cl * RNH ? 2 * h : h;
  return bmp * (2 * d + hidden + G * np) + BM + k5::ring_floats(S, BK, cl * RNH, cl * RNO);
}

}  // namespace stack
}  // namespace pocomc
