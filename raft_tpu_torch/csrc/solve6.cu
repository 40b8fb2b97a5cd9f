// Kernels K1 and K2: the 6x6 complex solve for Hopper, fused with the RAO
// impedance assembly (K1) or plain (K2).
//
// K1 replaces the TPU kernel raft_tpu/core/pallas6.py::_fused_kernel
// (reached through _solve_rao_blocked / solve_rao_pallas and, for the
// adjoint solve of the differentiable fixed point, solve_rao_pallas_ad).
// Per lane (one design x one frequency) it forms Z = Z0 + i*w*B_drag and
// solves Z x = F.  K2 replaces raft_tpu/core/pallas6.py::_kernel (reached
// through _solve_blocked / solve_cx_pallas and solve_cx_pallas_ad): it
// solves A x = b as given.  Both are one template, solve6_kernel<T, FUSED>,
// with the drag assembly compiled out when FUSED is false; the elimination
// is the TPU kernels' shared body (pallas6.py::_eliminate), unrolled
// complex Gaussian elimination with partial pivoting:
//   * the pivot is the strict maximum of |.|^2 over rows >= k, so a tie
//     keeps the lowest row (the one-hot rule of the TPU kernel);
//   * a zero denominator is replaced by 1 (pivot and back substitution);
//   * rows and columns are swapped only from column k on, as on the TPU.
//
// Layout.  Z0 (or A) re/im: (N, 36) row-major systems; F (or b) re/im and
// x re/im: (N, 6).  K1 only: w (nw,) shared by every design, read as
// w[lane % nw]; B_drag (N / nw, 36), one drag matrix per design, read as
// B_drag[lane / nw].  The broadcast (N, 36) B_drag that the TPU wrapper
// materializes never exists.  The ragged edge is an `if (lane < n)` guard,
// not identity padding.
//
// Bound on an H100.  Per lane K1 reads Z0 (72 values) and F (12) and
// writes x (12); w and B_drag are amortized over nw.  At the north star's
// 1,000 x 200 lanes that is 77 MB in f32 / 154 MB in f64, i.e. about
// 23 us / 46 us at 3.35 TB/s.  K2 moves the same 96 values per system: at
// its microbench's 16,384 systems in f32, 6.3 MB or 1.9 us.  The
// arithmetic (about 2k flops per system) is far below the compute limit,
// so both are bound by bytes.
//
// Design: one thread per system, everything in registers (every loop is
// fully unrolled with compile-time indices, and the pivot swap is a
// predicated select, so no array is indexed dynamically and nothing goes
// to local memory).  This first version reads each system's 36 entries
// from consecutive addresses, so a warp's loads are strided by 36 values
// (not coalesced); lane-major (36, N) planes, shared-memory staging and
// the register pressure (about 100 live values per thread in f64) are
// left for later work.  Launch: 128 threads per block on the caller's
// stream, no synchronization; the C entry returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ void swap_if(bool c, T& a, T& b) {
  const T ta = a;
  a = c ? b : a;
  b = c ? ta : b;
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(128)
solve6_kernel(const T* __restrict__ z0r, const T* __restrict__ z0i,
                    const T* __restrict__ w, const T* __restrict__ bd,
                    const T* __restrict__ fr, const T* __restrict__ fi,
                    T* __restrict__ xr, T* __restrict__ xi,
                    long long n, long long nw) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  T ar[36], ai[36], br[6], bi[6];
  const T* __restrict__ zr = z0r + lane * 36;
  const T* __restrict__ zi = z0i + lane * 36;
  if constexpr (FUSED) {
    const T wl = w[lane % nw];
    const T* __restrict__ bdl = bd + (lane / nw) * 36;
#pragma unroll
    for (int e = 0; e < 36; ++e) {
      ar[e] = zr[e];
      ai[e] = zi[e] + wl * bdl[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 36; ++e) {
      ar[e] = zr[e];
      ai[e] = zi[e];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    br[i] = fr[lane * 6 + i];
    bi[i] = fi[lane * 6 + i];
  }

#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // partial pivot: strict '>' so the lowest row wins a tie
    int p = k;
    T best = ar[k * 6 + k] * ar[k * 6 + k] + ai[k * 6 + k] * ai[k * 6 + k];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) {
      const T m = ar[j * 6 + k] * ar[j * 6 + k] + ai[j * 6 + k] * ai[j * 6 + k];
      if (m > best) {
        best = m;
        p = j;
      }
    }
#pragma unroll
    for (int j = k + 1; j < 6; ++j) {
      const bool s = (p == j);
#pragma unroll
      for (int c = k; c < 6; ++c) {
        swap_if(s, ar[k * 6 + c], ar[j * 6 + c]);
        swap_if(s, ai[k * 6 + c], ai[j * 6 + c]);
      }
      swap_if(s, br[k], br[j]);
      swap_if(s, bi[k], bi[j]);
    }

    T den = ar[k * 6 + k] * ar[k * 6 + k] + ai[k * 6 + k] * ai[k * 6 + k];
    den = (den != T(0)) ? den : T(1);
#pragma unroll
    for (int j = k + 1; j < 6; ++j) {
      const T f_r = (ar[j * 6 + k] * ar[k * 6 + k] + ai[j * 6 + k] * ai[k * 6 + k]) / den;
      const T f_i = (ai[j * 6 + k] * ar[k * 6 + k] - ar[j * 6 + k] * ai[k * 6 + k]) / den;
#pragma unroll
      for (int c = k; c < 6; ++c) {
        const T nr = ar[j * 6 + c] - (f_r * ar[k * 6 + c] - f_i * ai[k * 6 + c]);
        const T ni = ai[j * 6 + c] - (f_r * ai[k * 6 + c] + f_i * ar[k * 6 + c]);
        ar[j * 6 + c] = nr;
        ai[j * 6 + c] = ni;
      }
      const T nbr = br[j] - (f_r * br[k] - f_i * bi[k]);
      const T nbi = bi[j] - (f_r * bi[k] + f_i * br[k]);
      br[j] = nbr;
      bi[j] = nbi;
    }
  }

  T sol_r[6], sol_i[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    T sr = br[k], si = bi[k];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) {
      sr = sr - (ar[k * 6 + j] * sol_r[j] - ai[k * 6 + j] * sol_i[j]);
      si = si - (ar[k * 6 + j] * sol_i[j] + ai[k * 6 + j] * sol_r[j]);
    }
    T den = ar[k * 6 + k] * ar[k * 6 + k] + ai[k * 6 + k] * ai[k * 6 + k];
    den = (den != T(0)) ? den : T(1);
    sol_r[k] = (sr * ar[k * 6 + k] + si * ai[k * 6 + k]) / den;
    sol_i[k] = (si * ar[k * 6 + k] - sr * ai[k * 6 + k]) / den;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    xr[lane * 6 + i] = sol_r[i];
    xi[lane * 6 + i] = sol_i[i];
  }
}

template <typename T, bool FUSED>
int launch(const void* z0r, const void* z0i, const void* w, const void* bd,
           const void* fr, const void* fi, void* xr, void* xi,
           long long n, long long nw, void* stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  solve6_kernel<T, FUSED><<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)z0r, (const T*)z0i, (const T*)w, (const T*)bd,
      (const T*)fr, (const T*)fi, (T*)xr, (T*)xi, n, nw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int solve6_fused_f32(const void* z0r, const void* z0i, const void* w,
                                const void* bd, const void* fr, const void* fi,
                                void* xr, void* xi, long long n, long long nw,
                                void* stream) {
  return launch<float, true>(z0r, z0i, w, bd, fr, fi, xr, xi, n, nw, stream);
}

extern "C" int solve6_fused_f64(const void* z0r, const void* z0i, const void* w,
                                const void* bd, const void* fr, const void* fi,
                                void* xr, void* xi, long long n, long long nw,
                                void* stream) {
  return launch<double, true>(z0r, z0i, w, bd, fr, fi, xr, xi, n, nw, stream);
}

extern "C" int solve6_plain_f32(const void* ar, const void* ai, const void* br,
                                const void* bi, void* xr, void* xi, long long n,
                                void* stream) {
  return launch<float, false>(ar, ai, nullptr, nullptr, br, bi, xr, xi, n, 1, stream);
}

extern "C" int solve6_plain_f64(const void* ar, const void* ai, const void* br,
                                const void* bi, void* xr, void* xi, long long n,
                                void* stream) {
  return launch<double, false>(ar, ai, nullptr, nullptr, br, bi, xr, xi, n, 1, stream);
}
