// Kernel K5: one fixed-point step's stochastic drag linearization for Hopper.
//
// K5 replaces no TPU kernel.  It replaces the chain of jnp ops of
// raft_tpu/hydro/strip.py::linearized_drag (in the port,
// raft_tpu_torch/hydro/strip.py::linearized_drag, about 240 eager operations
// a call), which every fixed-point step of solve/dynamics.py::solve_dynamics
// runs once.  Per lane (one design, or one sea state of one design) and per
// submerged strip node n it computes, for the iterate Xi (nw, 6):
//   vnode[w]  = i w (Xi_t[w] + Xi_r[w] x r_n)                 node velocity
//   vrel[w]   = u_n[w] - vnode[w]                              relative velocity
//   s_d       = sum over (w, xyz) of |vrel|^2 d^2, d = q, p1, p2   moments
//   vRMS_d    = sqrt(s_d) (0 where s_d = 0)
//   B_d       = slope(U_d, vRMS_d) c_d, the Gaussian MMSE slope of |X| X
//               (2 U erf(U / (sigma sqrt 2)) + sqrt(8/pi) sigma exp(-(...)^2),
//               2 |U| at sigma = 0); the end disk takes q's slope
//   Bmat      = (B_q + B_end) q q^T + B_p1 p1 p1^T + B_p2 p2 p2^T    (3x3)
//   B6       += T(r_n) Bmat T(r_n)^T     (raft_tpu_torch/core/transforms.py::
//               translate_matrix_3to6)
//   F6[w]    += (Bmat u_n[w], r_n x Bmat u_n[w])     (translate_force_3to6)
// Nodes above the water or padded out (sub = 0) add nothing, as the mask
// multiply of the reference makes them add zeros.
//
// Layout.  coef (Lc, N, 20), one row a node: sub, U_q, U_p1, U_p2, c_q,
// c_p1, c_p2, c_end (c = rho/2 area Cd), q, p1, p2, r (three each); lane
// stride cs (0 when every lane shares one design's nodes).  u re/im: the
// node kinematics (lane, node, w, xyz) at the element strides the caller
// passes (lane stride 0 when the lanes share them; the strip path keeps w
// innermost, so the threads of a warp read consecutive addresses).  Xi
// re/im (L, nw, 6), w (nw,), B6 (L, 36), F6 re/im (L, nw, 6), contiguous.
//
// What bounds it on an H100.  Per lane and step it reads u at the submerged
// nodes (N_sub x nw x 6 values) and Xi (nw x 12), and writes F6 (nw x 12)
// and B6 (36); about 60 operations per (node, w).  At the wide sweep's 2,048
// OC3 lanes (14 of 26 nodes submerged) x 200 w in f32 that is 138 MB of u
// and 39 MB of Xi and F6: 53 us at 3.35 TB/s, at 0.35 GFLOP far from the
// compute limit.  The bound is bytes.
//
// Design.  One block per lane, one thread per frequency (PER frequencies a
// thread above 256), the block's threads a multiple of 32.  Each thread keeps
// its frequencies' Xi and F6 in registers for the whole node loop, so nothing
// of size (N, nw, .) is ever written.  Per submerged node: each thread loads
// its u (6 values, coalesced), forms its share of the three moments, and one
// block reduction completes them: a shuffle tree in each warp, the warps'
// partials in shared memory, summed by every thread in warp order.  The
// partials alternate between two buffers, so one barrier per node suffices.
// Every thread then forms the node's Bmat from the moments (the slope's erf
// and exp are repeated per thread instead of broadcast, which would cost a
// second barrier), adds Bmat u and r x Bmat u to its F6, and threads 0..35
// add one element each of T(r) Bmat T(r)^T to B6.  No atomics: the sums run
// in one fixed order, so a run repeats the last one bit for bit.
//
// Built with -fmad=false: each product and sum rounds as the plain version's
// elementwise operations do (raft_tpu_torch/core/cuda_drag.py).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kCoef = 20;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float erf_(float x) { return erff(x); }
__device__ __forceinline__ double erf_(double x) { return erf(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// Gaussian MMSE slope of |X| X for X ~ N(U, sigma^2); 2|U| at sigma = 0
// (raft_tpu_torch/hydro/strip.py::_gauss_drag_slope).
template <typename T>
__device__ __forceinline__ T slope(T U, T sigma) {
  if (!(sigma > T(0))) return T(2) * abs_(U);
  const T r = U / (sigma * T(1.4142135623730951));
  return T(2) * U * erf_(r) + T(1.5957691216057308) * sigma * exp_(-(r * r));
}

// H[a][k] of the alternator of r for a constant a and a runtime k
// (raft_tpu_torch/core/transforms.py::alternator).
template <typename T>
__device__ __forceinline__ T alt(const T (&r)[3], int a, int k) {
  const T h0 = a == 0 ? T(0) : (a == 1 ? -r[2] : r[1]);
  const T h1 = a == 0 ? r[2] : (a == 1 ? T(0) : -r[0]);
  const T h2 = a == 0 ? -r[1] : (a == 1 ? r[0] : T(0));
  return k == 0 ? h0 : (k == 1 ? h1 : h2);
}

template <typename T, int PER>
__global__ void __launch_bounds__(kMaxThreads)
drag_kernel(const T* __restrict__ coef, long long cs, const T* __restrict__ ur,
            const T* __restrict__ ui, long long us_l, long long us_n, long long us_w,
            long long us_c, const T* __restrict__ xr, const T* __restrict__ xi,
            const T* __restrict__ w, T* __restrict__ b6, T* __restrict__ fr,
            T* __restrict__ fi, int n_nodes, int nw) {
  __shared__ T part[2][kMaxWarps][3];
  const long long lane = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int nwarps = blockDim.x / 32;

  T om[PER], xtr[PER][3], xti[PER][3], xrr[PER][3], xri[PER][3];
  T acc_r[PER][6], acc_i[PER][6];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = t + k * blockDim.x;
    const bool on = j < nw;
    const long long base = (lane * nw + j) * 6;
    om[k] = on ? w[j] : T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xtr[k][c] = on ? xr[base + c] : T(0);
      xti[k][c] = on ? xi[base + c] : T(0);
      xrr[k][c] = on ? xr[base + 3 + c] : T(0);
      xri[k][c] = on ? xi[base + 3 + c] : T(0);
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      acc_r[k][c] = T(0);
      acc_i[k][c] = T(0);
    }
  }
  // thread t < 36 owns element (t / 6, t % 6) of B6
  const int bi = t / 6, bj = t % 6;
  T b6acc = T(0);
  int buf = 0;

  const T* __restrict__ cl = coef + lane * cs;
  const long long ul = lane * us_l;
  for (int n = 0; n < n_nodes; ++n) {
    const T* __restrict__ cn = cl + static_cast<long long>(n) * kCoef;
    if (cn[0] == T(0)) continue;           // the same for the whole block
    const T q[3] = {cn[8], cn[9], cn[10]};
    const T p1[3] = {cn[11], cn[12], cn[13]};
    const T p2[3] = {cn[14], cn[15], cn[16]};
    const T r[3] = {cn[17], cn[18], cn[19]};

    T u_r[PER][3], u_i[PER][3];
    T sq = T(0), sp1 = T(0), sp2 = T(0);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = t + k * blockDim.x;
      const bool on = j < nw;
      const long long at = ul + n * us_n + static_cast<long long>(j) * us_w;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        u_r[k][c] = on ? ur[at + c * us_c] : T(0);
        u_i[k][c] = on ? ui[at + c * us_c] : T(0);
      }
      // disp = Xi_t + Xi_r x r; vnode = i w disp = (-w disp.im, w disp.re)
      const T dr[3] = {xtr[k][0] + (xrr[k][1] * r[2] - xrr[k][2] * r[1]),
                       xtr[k][1] + (xrr[k][2] * r[0] - xrr[k][0] * r[2]),
                       xtr[k][2] + (xrr[k][0] * r[1] - xrr[k][1] * r[0])};
      const T di[3] = {xti[k][0] + (xri[k][1] * r[2] - xri[k][2] * r[1]),
                       xti[k][1] + (xri[k][2] * r[0] - xri[k][0] * r[2]),
                       xti[k][2] + (xri[k][0] * r[1] - xri[k][1] * r[0])};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T vr = u_r[k][c] - (-(di[c] * om[k]));
        const T vi = u_i[k][c] - dr[c] * om[k];
        const T v2 = vr * vr + vi * vi;
        sq = sq + v2 * (q[c] * q[c]);
        sp1 = sp1 + v2 * (p1[c] * p1[c]);
        sp2 = sp2 + v2 * (p2[c] * p2[c]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sq = sq + __shfl_down_sync(kFull, sq, off);
      sp1 = sp1 + __shfl_down_sync(kFull, sp1, off);
      sp2 = sp2 + __shfl_down_sync(kFull, sp2, off);
    }
    if (t % 32 == 0) {
      part[buf][warp][0] = sq;
      part[buf][warp][1] = sp1;
      part[buf][warp][2] = sp2;
    }
    __syncthreads();
    T s[3] = {T(0), T(0), T(0)};
    for (int v = 0; v < nwarps; ++v) {
#pragma unroll
      for (int m = 0; m < 3; ++m) s[m] = s[m] + part[buf][v][m];
    }
    buf ^= 1;

    const T sl_q = slope(cn[1], s[0] > T(0) ? sqrt_(s[0]) : T(0));
    const T sl_p1 = slope(cn[2], s[1] > T(0) ? sqrt_(s[1]) : T(0));
    const T sl_p2 = slope(cn[3], s[2] > T(0) ? sqrt_(s[2]) : T(0));
    const T bq = sl_q * cn[4] + sl_q * cn[7];
    const T bp1 = sl_p1 * cn[5];
    const T bp2 = sl_p2 * cn[6];
    T M[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        M[a][b] = bq * (q[a] * q[b]) + bp1 * (p1[a] * p1[b]) + bp2 * (p2[a] * p2[b]);
      }
    }

    if (t < 36) {
      // T(r) Bmat T(r)^T = G Bmat G^T with G = (I; -H), H = alternator(r):
      // H[0] = (0, z, -y), H[1] = (-z, 0, x), H[2] = (y, -x, 0), so row k of -H
      // is column k of H.  The rows of G are picked by selects on constant
      // indices, which keeps M and G in registers.
      T gi[3], gj[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gi[a] = bi < 3 ? T(a == bi) : alt(r, a, bi - 3);
        gj[a] = bj < 3 ? T(a == bj) : alt(r, a, bj - 3);
      }
      T e = T(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T v = gi[0] * M[0][b] + gi[1] * M[1][b] + gi[2] * M[2][b];
        e = e + v * gj[b];
      }
      b6acc = b6acc + e;
    }

#pragma unroll
    for (int k = 0; k < PER; ++k) {
      T f_r[3], f_i[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        f_r[a] = M[a][0] * u_r[k][0] + M[a][1] * u_r[k][1] + M[a][2] * u_r[k][2];
        f_i[a] = M[a][0] * u_i[k][0] + M[a][1] * u_i[k][1] + M[a][2] * u_i[k][2];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc_r[k][a] = acc_r[k][a] + f_r[a];
        acc_i[k][a] = acc_i[k][a] + f_i[a];
      }
      acc_r[k][3] = acc_r[k][3] + (r[1] * f_r[2] - r[2] * f_r[1]);
      acc_r[k][4] = acc_r[k][4] + (r[2] * f_r[0] - r[0] * f_r[2]);
      acc_r[k][5] = acc_r[k][5] + (r[0] * f_r[1] - r[1] * f_r[0]);
      acc_i[k][3] = acc_i[k][3] + (r[1] * f_i[2] - r[2] * f_i[1]);
      acc_i[k][4] = acc_i[k][4] + (r[2] * f_i[0] - r[0] * f_i[2]);
      acc_i[k][5] = acc_i[k][5] + (r[0] * f_i[1] - r[1] * f_i[0]);
    }
  }

  if (t < 36) b6[lane * 36 + t] = b6acc;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = t + k * blockDim.x;
    if (j < nw) {
      const long long base = (lane * nw + j) * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        fr[base + c] = acc_r[k][c];
        fi[base + c] = acc_i[k][c];
      }
    }
  }
}

template <typename T>
int launch(const void* coef, long long cs, const void* ur, const void* ui, long long us_l,
           long long us_n, long long us_w, long long us_c, const void* xr, const void* xi,
           const void* w, void* b6, void* fr, void* fi, long long lanes, long long n_nodes,
           long long nw, long long threads, long long per, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(lanes));
  const dim3 block(static_cast<unsigned>(threads));
#define K5_ARGS                                                                           \
  static_cast<const T*>(coef), cs, static_cast<const T*>(ur), static_cast<const T*>(ui), \
      us_l, us_n, us_w, us_c, static_cast<const T*>(xr), static_cast<const T*>(xi),      \
      static_cast<const T*>(w), static_cast<T*>(b6), static_cast<T*>(fr),                \
      static_cast<T*>(fi), static_cast<int>(n_nodes), static_cast<int>(nw)
  if (threads % 32 != 0 || threads > kMaxThreads || threads * per < nw)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (per) {
    case 1: drag_kernel<T, 1><<<grid, block, 0, s>>>(K5_ARGS); break;
    case 2: drag_kernel<T, 2><<<grid, block, 0, s>>>(K5_ARGS); break;
    case 4: drag_kernel<T, 4><<<grid, block, 0, s>>>(K5_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int drag_step_f32(const void* coef, long long cs, const void* ur, const void* ui,
                  long long us_l, long long us_n, long long us_w, long long us_c,
                  const void* xr, const void* xi, const void* w, void* b6, void* fr, void* fi,
                  long long lanes, long long n_nodes, long long nw, long long threads,
                  long long per, void* stream) {
  return launch<float>(coef, cs, ur, ui, us_l, us_n, us_w, us_c, xr, xi, w, b6, fr, fi, lanes,
                       n_nodes, nw, threads, per, stream);
}

int drag_step_f64(const void* coef, long long cs, const void* ur, const void* ui,
                  long long us_l, long long us_n, long long us_w, long long us_c,
                  const void* xr, const void* xi, const void* w, void* b6, void* fr, void* fi,
                  long long lanes, long long n_nodes, long long nw, long long threads,
                  long long per, void* stream) {
  return launch<double>(coef, cs, ur, ui, us_l, us_n, us_w, us_c, xr, xi, w, b6, fr, fi, lanes,
                        n_nodes, nw, threads, per, stream);
}

}  // extern "C"
