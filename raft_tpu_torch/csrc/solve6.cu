// Kernels K1 and K2: the 6x6 complex solve for Hopper, fused with the RAO
// impedance assembly (K1) or plain (K2), each with an adjoint mode.
//
// K1 replaces the TPU kernel raft_tpu/core/pallas6.py::_fused_kernel
// (reached through _solve_rao_blocked / solve_rao_pallas and, for the
// adjoint solve of the differentiable fixed point, solve_rao_pallas_ad).
// Per lane (one design x one frequency) it forms Z = Z0 + i*w*B_drag and
// solves Z x = F.  K2 replaces raft_tpu/core/pallas6.py::_kernel (reached
// through _solve_blocked / solve_cx_pallas and solve_cx_pallas_ad): it
// solves A x = b as given.  Both are one template, solve6_kernel<T, FUSED,
// ADJOINT>; the elimination is the TPU kernels' shared body
// (pallas6.py::_eliminate), complex Gaussian elimination with partial
// pivoting:
//   * the pivot is the strict maximum of |.|^2 over rows >= k, so a tie
//     keeps the lowest row (the one-hot rule of the TPU kernel);
//   * a zero denominator is replaced by 1 (pivot and back substitution);
//   * rows k and p exchange places from column k on (columns left of k
//     are never read again).
// ADJOINT solves with the conjugate transpose in place: element (r, c) of
// the system is conj(Z0[c, r]) + i*w*(-B_drag[c, r]) (K1) or conj(A[c, r])
// (K2), read from the caller's arrays, so the backward of the
// differentiable solve makes no transposed copies.
//
// Layout.  Z0 (or A) re/im: (N, 36) row-major systems; F (or b) re/im and
// x re/im: (N, 6).  K1 only: w (nw,) shared by every design, read as
// w[lane % nw]; B_drag (N / nw, 36), one drag matrix per design, read as
// B_drag[lane / nw].
//
// What bounds it on an H100.  Per system K1 reads Z0 (72 values) and F
// (12) and writes x (12); w and B_drag are amortized over nw.  At the
// sweep's and the gradient's call of 250 x 200 systems that is 19 MB in f32
// (5.7 us at 3.35 TB/s), and about 2k operations per system are far below
// the compute limit: the bound is bytes.  One thread per system (the
// port's first design) runs at about 3x the bound at that call: 391 blocks
// of 128 threads, 128-226 registers a thread, a serial chain of six pivot
// steps and six back-substitution steps, each with divisions, that too
// few warps hide, and loads strided by 36 values between neighbours.
//
// Design.  Eight lanes per system, one matrix row per lane (lanes 6 and 7
// hold no row), four systems per warp, 16 per block of 128 threads: 8x the
// threads at 48 registers a thread in f32 and 92 in f64, no spills.  The
// block's 16 systems are contiguous, so Z0 (or A) is staged through shared
// memory by consecutive threads reading consecutive addresses; then each
// lane takes its row (in ADJOINT mode, its column).  Per column k:
//   * the pivot is a shuffle reduction over the system's 8 lanes on
//     (|.|^2, position): the larger magnitude wins, the lower position
//     breaks a tie -- exactly the sequential strict '>' scan;
//   * the exchange of rows k and p is a relabelling: each lane keeps its
//     row and its position (0..5) in the permuted system, and the lanes at
//     positions k and p trade positions, so no value moves;
//   * the pivot row is broadcast from its lane by shuffles, and each lane
//     below position k eliminates its own row, in the same operations as
//     the plain version.
// Back substitution runs k = 5..0: the lane at position k computes x_k
// (every lane evaluates its own row in lockstep) and broadcasts it.  F, b
// and x are read and written by the row lanes at consecutive addresses.
// Every lane of the warp stays to the end (the shuffles need all of them);
// the ragged edge is a guard on loads and stores.
//
// Measured on the card (PERF.md, raft_tpu_torch/tools/k1_layouts.py, the
// same bits as one thread a system): 1.8x slower than one thread a system
// with vector loads at 250 x 200 systems and 2.4x at 1,000 x 200.  The
// lanes issue the instructions of every step for all eight while 5 - k of
// them have a row to eliminate, and each lane repeats the back
// substitution's divisions; the kernel is bound by instruction issue, not
// by bytes.  Staging the block's systems through shared memory with one
// thread a system is slower than vector loads too (1.2-1.5x).
//
// Built with -fmad=false: each product and sum rounds as the plain
// version's elementwise operations do (raft_tpu_torch/core/linalg6.py), so
// |.|^2 of two rows that tie in exact arithmetic also ties here.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;                  // lanes per system
constexpr int kThreads = 128;
constexpr int kSys = kThreads / kLanes;    // systems per block
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(kFull, v, src, kLanes);
}

template <typename T, bool FUSED, bool ADJOINT>
__global__ void __launch_bounds__(kThreads)
solve6_kernel(const T* __restrict__ z0r, const T* __restrict__ z0i,
              const T* __restrict__ w, const T* __restrict__ bd,
              const T* __restrict__ fr, const T* __restrict__ fi,
              T* __restrict__ xr, T* __restrict__ xi, long long n, long long nw) {
  __shared__ T s_re[kSys * 36];
  __shared__ T s_im[kSys * 36];
  const long long first = static_cast<long long>(blockIdx.x) * kSys;
  const int nsys = static_cast<int>(min(static_cast<long long>(kSys), n - first));
  for (int e = threadIdx.x; e < nsys * 36; e += kThreads) {
    s_re[e] = z0r[first * 36 + e];
    s_im[e] = z0i[first * 36 + e];
  }
  __syncthreads();

  const int slot = threadIdx.x / kLanes;
  const int r = threadIdx.x % kLanes;      // this lane's row
  const long long sys = first + slot;
  const bool live = slot < nsys && r < 6;
  const T* __restrict__ sr_ = s_re + slot * 36;
  const T* __restrict__ si_ = s_im + slot * 36;

  T ar[6], ai[6], br = T(0), bi = T(0);
  T wl = T(0);
  const T* __restrict__ bdl = nullptr;
  if constexpr (FUSED) {
    if (live) {
      wl = w[sys % nw];
      bdl = bd + (sys / nw) * 36;
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    if (!live) {
      ar[c] = T(0);
      ai[c] = T(0);
      continue;
    }
    const int e = ADJOINT ? c * 6 + r : r * 6 + c;
    ar[c] = sr_[e];
    if constexpr (ADJOINT) {
      if constexpr (FUSED) {
        ai[c] = -si_[e] + wl * (-bdl[e]);
      } else {
        ai[c] = -si_[e];
      }
    } else {
      if constexpr (FUSED) {
        ai[c] = si_[e] + wl * bdl[e];
      } else {
        ai[c] = si_[e];
      }
    }
  }
  if (live) {
    br = fr[sys * 6 + r];
    bi = fi[sys * 6 + r];
  }

  // pos: this row's place in the permuted system (lanes 6 and 7 sit at 6
  // and 7 and never take part); piv[k]: the lane holding position k
  int pos = r;
  int piv[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // pivot: largest |.|^2 over positions >= k, the lowest position on a
    // tie; key = position * 8 + lane, so the position decides a tie
    T m = ar[k] * ar[k] + ai[k] * ai[k];
    int key = pos * kLanes + r;
    if (pos < k || r >= 6) m = T(-1);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const T om = __shfl_xor_sync(kFull, m, off, kLanes);
      const int ok = __shfl_xor_sync(kFull, key, off, kLanes);
      if (om > m || (om == m && ok < key)) {
        m = om;
        key = ok;
      }
    }
    const int p = key / kLanes;            // the pivot's position
    const int src = key % kLanes;          // and its lane
    piv[k] = src;
    // rows k and p trade places
    pos = pos == p ? k : (pos == k ? p : pos);
    // the pivot row, to every lane of the system
    T pr[6], pi[6];
#pragma unroll
    for (int c = k; c < 6; ++c) {
      pr[c] = shfl(ar[c], src);
      pi[c] = shfl(ai[c], src);
    }
    const T pbr = shfl(br, src), pbi = shfl(bi, src);
    T den = pr[k] * pr[k] + pi[k] * pi[k];
    den = (den != T(0)) ? den : T(1);
    if (pos > k && r < 6) {
      const T f_r = (ar[k] * pr[k] + ai[k] * pi[k]) / den;
      const T f_i = (ai[k] * pr[k] - ar[k] * pi[k]) / den;
#pragma unroll
      for (int c = k; c < 6; ++c) {
        const T nr = ar[c] - (f_r * pr[c] - f_i * pi[c]);
        const T ni = ai[c] - (f_r * pi[c] + f_i * pr[c]);
        ar[c] = nr;
        ai[c] = ni;
      }
      const T nbr = br - (f_r * pbr - f_i * pbi);
      const T nbi = bi - (f_r * pbi + f_i * pbr);
      br = nbr;
      bi = nbi;
    }
  }

  // back substitution: the lane at position k computes x_k
  T sol_r[6], sol_i[6];
  T mine_r = T(0), mine_i = T(0);
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    T sr = br, si = bi;
#pragma unroll
    for (int j = k + 1; j < 6; ++j) {
      sr = sr - (ar[j] * sol_r[j] - ai[j] * sol_i[j]);
      si = si - (ar[j] * sol_i[j] + ai[j] * sol_r[j]);
    }
    T den = ar[k] * ar[k] + ai[k] * ai[k];
    den = (den != T(0)) ? den : T(1);
    const T vr = (sr * ar[k] + si * ai[k]) / den;
    const T vi = (si * ar[k] - sr * ai[k]) / den;
    sol_r[k] = shfl(vr, piv[k]);
    sol_i[k] = shfl(vi, piv[k]);
    if (r == k) {
      mine_r = sol_r[k];
      mine_i = sol_i[k];
    }
  }
  if (live) {
    xr[sys * 6 + r] = mine_r;
    xi[sys * 6 + r] = mine_i;
  }
}

template <typename T, bool FUSED>
int launch(const void* z0r, const void* z0i, const void* w, const void* bd, const void* fr,
           const void* fi, void* xr, void* xi, long long n, long long nw, long long adjoint,
           void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kSys - 1) / kSys));
  const auto s = static_cast<cudaStream_t>(stream);
  if (adjoint) {
    solve6_kernel<T, FUSED, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(z0r), static_cast<const T*>(z0i), static_cast<const T*>(w),
        static_cast<const T*>(bd), static_cast<const T*>(fr), static_cast<const T*>(fi),
        static_cast<T*>(xr), static_cast<T*>(xi), n, nw);
  } else {
    solve6_kernel<T, FUSED, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(z0r), static_cast<const T*>(z0i), static_cast<const T*>(w),
        static_cast<const T*>(bd), static_cast<const T*>(fr), static_cast<const T*>(fi),
        static_cast<T*>(xr), static_cast<T*>(xi), n, nw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int solve6_fused_f32(const void* z0r, const void* z0i, const void* w, const void* bd,
                     const void* fr, const void* fi, void* xr, void* xi, long long n,
                     long long nw, long long adjoint, void* stream) {
  return launch<float, true>(z0r, z0i, w, bd, fr, fi, xr, xi, n, nw, adjoint, stream);
}

int solve6_fused_f64(const void* z0r, const void* z0i, const void* w, const void* bd,
                     const void* fr, const void* fi, void* xr, void* xi, long long n,
                     long long nw, long long adjoint, void* stream) {
  return launch<double, true>(z0r, z0i, w, bd, fr, fi, xr, xi, n, nw, adjoint, stream);
}

int solve6_plain_f32(const void* ar, const void* ai, const void* br, const void* bi,
                     void* xr, void* xi, long long n, long long adjoint, void* stream) {
  return launch<float, false>(ar, ai, nullptr, nullptr, br, bi, xr, xi, n, 1, adjoint, stream);
}

int solve6_plain_f64(const void* ar, const void* ai, const void* br, const void* bi,
                     void* xr, void* xi, long long n, long long adjoint, void* stream) {
  return launch<double, false>(ar, ai, nullptr, nullptr, br, bi, xr, xi, n, 1, adjoint,
                               stream);
}

}  // extern "C"
