// Kernel K4: the free-surface wave part of the BEM Green function for one
// chunk of frequencies, combined with the Rankine parts, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel raft_tpu/core/pallas_bem.py::_wave_kernel
// (reached through wave_assembly, vmapped over a frequency chunk).  For
// every frequency f of the chunk and pair (field i, source j) it returns
//   S[f, i, j]  = (R_pot[i, j] + G area_j) mask_j              (complex)
//   Dn[f, i, j] = (R_dn[i, j] + (grad G . n_i) area_j) mask_j  (complex)
// with G the wave part of the Green function:
//   deep water: 2k [I0 - i pi e^Y J0] with I0/I1 from the region split of
//     the wave integrals -- near (rho < R_NEAR): 16-node theta quadrature
//     of the 12-term E1 series; table: bilinear interpolation of the
//     smooth parts plus the singular closed forms; far (X >= XMAX): Y0/Y1;
//     very deep (s >= SMAX): the 1/rho tail;
//   finite depth (frequencies with active = 1): four images, each a pole
//     part (the same wave integrals at (k0 R, -k0 d_i)) and a 46-term
//     exponential fit, the radiated part and a seabed image.
// A lid self pair evaluates at R_eff = 0.4 sqrt(area).  The -2 pi diagonal
// shift, the lid-row swap and the solve stay outside, as in the JAX package.
//
// Design.  One thread per (i, j) pair, blockIdx.z the frequency of the
// chunk; j is the fastest thread index, so loads of R_pot/R_dn and the four
// stores of a warp are contiguous.  The TPU kernel evaluates every region
// densely and selects with `where`; here each pair takes exactly one
// region branch, and the deep / finite-depth choice is uniform across the
// block (it depends on the frequency only).  The two 900 x 200 tables
// (1.44 MB each in f64) do not fit the 227 KB of shared memory a block may
// use; they are read through L2 with __ldg.  The Bessel functions are the
// same polynomial approximations as raft_tpu_torch/core/bessel.py (not
// CUDA's j0/y0, which use other approximations).
//
// Bound.  Deep-water frequencies read two and write four n x n planes (6 n^2
// values) and do a few hundred operations per pair: near the byte bound.
// Finite-depth frequencies do 4 images x (wave integrals + 46 fit terms)
// per pair and are bound by operations.  Later work (not done here): stage
// field and source panels in shared memory, split near pairs into their
// own pass so warps do not diverge on the 16-node quadrature.
//
// Built with -fmad=false, so products and sums round as PyTorch's
// elementwise kernels round them in the plain version
// (raft_tpu_torch/hydro/torch_bem.py::wave_plain).
#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kEuler = 0.5772156649015329;
constexpr double k2OverPi = 0.636619772367581343;
constexpr double kRNear = 0.6;
constexpr int kNSeries = 12;
constexpr int kNodes = 16;

__constant__ double kJ0sNum[6] = {57568490574.0, -13362590354.0, 651619640.7,
                                  -11214424.18, 77392.33017, -184.9052456};
__constant__ double kJ0sDen[6] = {57568490411.0, 1029532985.0, 9494680.718,
                                  59272.64853, 267.8532712, 1.0};
__constant__ double kJ1sNum[6] = {72362614232.0, -7895059235.0, 242396853.1,
                                  -2972611.439, 15704.48260, -30.16036606};
__constant__ double kJ1sDen[6] = {144725228442.0, 2300535178.0, 18583304.74,
                                  99447.43394, 376.9991397, 1.0};
__constant__ double kY0sNum[6] = {-2957821389.0, 7062834065.0, -512359803.6,
                                  10879881.29, -86327.92757, 228.4622733};
__constant__ double kY0sDen[6] = {40076544269.0, 745249964.8, 7189466.438,
                                  47447.26470, 226.1030244, 1.0};
__constant__ double kY1sNum[6] = {-0.4900604943e13, 0.1275274390e13, -0.5153438139e11,
                                  0.7349264551e9, -0.4237922726e7, 0.8511937935e4};
__constant__ double kY1sDen[7] = {0.2499580570e14, 0.4244419664e12, 0.3733650367e10,
                                  0.2245904002e8, 0.1020426050e6, 0.3549632885e3, 1.0};
__constant__ double kP0[5] = {1.0, -0.1098628627e-2, 0.2734510407e-4, -0.2073370639e-5,
                              0.2093887211e-6};
__constant__ double kQ0[5] = {-0.1562499995e-1, 0.1430488765e-3, -0.6911147651e-5,
                              0.7621095161e-6, -0.934935152e-7};
__constant__ double kP1[5] = {1.0, 0.183105e-2, -0.3516396496e-4, 0.2457520174e-5,
                              -0.240337019e-6};
__constant__ double kQ1[5] = {0.04687499995, -0.2002690873e-3, 0.8449199096e-5,
                              -0.88228987e-6, 0.105787412e-6};

template <typename T, int N>
__device__ __forceinline__ T horner(T y, const double (&c)[N]) {
  T acc = T(c[N - 1]);
#pragma unroll
  for (int k = N - 2; k >= 0; --k) acc = T(c[k]) + y * acc;
  return acc;
}

// sqrt(2/(pi x)) (cos(x - phase) P(y) - z sin(x - phase) Q(y)), z = 8/x
template <typename T, int N>
__device__ __forceinline__ T bessel_large(T ax, double phase, const double (&P)[N],
                                          const double (&Q)[N], bool y_kind) {
  const T z = T(8) / ax;
  const T y = z * z;
  const T xx = ax - T(phase);
  const T amp = sqrt(T(k2OverPi) / ax);
  if (y_kind) return amp * (sin(xx) * horner(y, P) + z * cos(xx) * horner(y, Q));
  return amp * (cos(xx) * horner(y, P) - z * sin(xx) * horner(y, Q));
}

template <typename T>
__device__ T bessel_j0(T x) {
  const T ax = fabs(x);
  if (ax < T(8)) {
    const T y = ax * ax;
    return horner(y, kJ0sNum) / horner(y, kJ0sDen);
  }
  return bessel_large(ax, 0.785398164, kP0, kQ0, false);
}

template <typename T>
__device__ T bessel_j1(T x) {
  const T ax = fabs(x);
  T out;
  if (ax < T(8)) {
    const T y = ax * ax;
    out = ax * horner(y, kJ1sNum) / horner(y, kJ1sDen);
  } else {
    out = bessel_large(ax, 2.356194491, kP1, kQ1, false);
  }
  const T sgn = x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
  return sgn * (x == T(0) ? T(0) : out);
}

template <typename T>
__device__ T bessel_y0(T x) {
  x = fmax(x, T(1e-30));
  if (x < T(8)) {
    const T y = x * x;
    return horner(y, kY0sNum) / horner(y, kY0sDen) + T(k2OverPi) * bessel_j0(x) * log(x);
  }
  return bessel_large(x, 0.785398164, kP0, kQ0, true);
}

template <typename T>
__device__ T bessel_y1(T x) {
  x = fmax(x, T(1e-30));
  if (x < T(8)) {
    const T y = x * x;
    return x * horner(y, kY1sNum) / horner(y, kY1sDen)
           + T(k2OverPi) * (bessel_j1(x) * log(x) - T(1) / x);
  }
  return bessel_large(x, 2.356194491, kP1, kQ1, true);
}

template <typename T>
struct Table {
  const T* I0;
  const T* I1;
  const T* glx;
  const T* glw;
  int nx, ns;
  T xmax, smax, fx_div, fs_div, far_thr, deep_thr;
};

// Re Phi(zeta) and Im dPhi(zeta) of the short E1 series, zeta = zr + i zi
template <typename T>
__device__ __forceinline__ void phi_near(T zr, T zi, T& phr, T& dphi) {
  T az2 = zr * zr + zi * zi;
  az2 = fmax(az2, T(1e-14));
  const T log_re = T(0.5) * log(az2);
  const T log_im = atan2(zi, zr);
  T tr = -zr, ti = -zi;
  T sr = -tr, si = -ti;
#pragma unroll
  for (int m = 2; m <= kNSeries; ++m) {
    const T nr = (tr * (-zr) - ti * (-zi)) / T(m);
    const T ni = (tr * (-zi) + ti * (-zr)) / T(m);
    tr = nr;
    ti = ni;
    sr = sr - tr / T(m);
    si = si - ti / T(m);
  }
  const T e1r = T(-kEuler) - log_re + sr;
  const T e1i = -log_im + si;
  const T ez = exp(zr);
  const T cr = cos(zi), ci = sin(zi);
  phr = ez * (cr * e1r - ci * (e1i + T(kPi)));
  const T phi = ez * (cr * (e1i + T(kPi)) + ci * e1r);
  dphi = phi + zi * (T(1) / az2);
}

template <typename T>
__device__ void near_integrals(T X, T Y, const Table<T>& tab, T& i0, T& i1) {
  T acc0 = T(0), accX = T(0);
#pragma unroll 1
  for (int q = 0; q < kNodes; ++q) {
    const T th = T(0.5 * kPi) + T(0.5 * kPi) * tab.glx[q];
    const T s = sin(th);
    const T w = tab.glw[q] * T(0.5) * T(kPi);
    T phr, dphi;
    phi_near(Y, X * s, phr, dphi);
    acc0 = acc0 + w * phr;
    accX = accX - w * s * dphi;
  }
  i0 = acc0 / T(kPi);
  const T dI0_dX = accX / T(kPi);
  const T rr = sqrt(fmax(X * X + Y * Y, T(1e-14)));
  const bool pos = X > T(1e-9);
  const T xs = pos ? X : T(1);
  const T C1 = pos ? (T(1) / xs) * (T(1) - (-Y) / rr) : T(0);
  i1 = pos ? -C1 - dI0_dX : T(0);
}

// (I0, I1) at X >= 0, Y <= 0: exactly one region of the JAX package's split
template <typename T>
__device__ void wave_integrals(T X, T Y, const Table<T>& tab, T& i0, T& i1) {
  const T rho = sqrt(X * X + Y * Y + T(1e-18));
  if (rho < T(kRNear)) {
    near_integrals(X, Y, tab, i0, i1);
    return;
  }
  const T s = log1p(-Y);
  if (X >= tab.far_thr) {
    const T eY = exp(Y);
    const T Xf = fmax(X, T(1));
    i0 = T(-kPi) * eY * bessel_y0(Xf);
    i1 = T(-kPi) * eY * bessel_y1(Xf);
    return;
  }
  const bool pos = X > T(1e-9);
  const T xs = pos ? X : T(1);
  if (s >= tab.deep_thr) {
    const T rr = fmax(rho, T(1e-30));
    i0 = -T(1) / rr;
    i1 = pos ? -(T(1) / xs) * (T(1) - (-Y) / rr) : T(0);
    return;
  }
  const T fx = fmin(fmax(X, T(0)), tab.xmax) / tab.fx_div;
  const int ix = min(max(static_cast<int>(fx), 0), tab.nx - 2);
  const T tx = fx - static_cast<T>(ix);
  const T fs = fmin(fmax(s, T(0)), tab.smax) / tab.fs_div;
  const int is = min(max(static_cast<int>(fs), 0), tab.ns - 2);
  const T ts = fs - static_cast<T>(is);
  const int o = ix * tab.ns + is;
  const T* I0 = tab.I0;
  const T* I1 = tab.I1;
  const T l0 = (T(1) - tx) * ((T(1) - ts) * __ldg(I0 + o) + ts * __ldg(I0 + o + 1))
               + tx * ((T(1) - ts) * __ldg(I0 + o + tab.ns) + ts * __ldg(I0 + o + tab.ns + 1));
  const T l1 = (T(1) - tx) * ((T(1) - ts) * __ldg(I1 + o) + ts * __ldg(I1 + o + 1))
               + tx * ((T(1) - ts) * __ldg(I1 + o + tab.ns) + ts * __ldg(I1 + o + tab.ns + 1));
  const T r2 = X * X + Y * Y;
  i0 = l0 + T(-0.5) * log(fmax(r2, T(1e-30)));
  const T r2c = fmax(r2, T(1e-30));
  const T C1 = pos ? (T(1) / xs) * (T(1) - (-Y) / sqrt(r2c)) : T(0);
  i1 = l1 + (-C1 + X / r2c);
}

template <typename T>
struct Cplx {
  T re, im;
};

template <typename T>
__device__ void wave_deep(T k, T R, T dx, T dy, T v, T area_j, bool diag_lid,
                          const Table<T>& tab, Cplx<T>& G, Cplx<T>& gx, Cplx<T>& gy,
                          Cplx<T>& gz) {
  const T R_eff = T(0.4) * sqrt(fmax(area_j, T(1e-14)));
  const T R_use = diag_lid ? R_eff : R;
  const T X = k * R_use;
  const T Y = k * v;
  T i0, i1;
  wave_integrals(X, Y, tab, i0, i1);
  const T eY = exp(Y);
  const T J0 = bessel_j0(X);
  const T J1 = bessel_j1(X);
  const T k2 = T(2) * k;
  G.re = k2 * i0;
  G.im = k2 * (T(-kPi) * eY * J0);
  const T rr = sqrt(R_use * R_use + v * v + T(1e-20));
  gz.re = k2 * (T(1) / rr + k * i0);
  gz.im = k2 * (T(-kPi) * k * eY * J0);
  const bool pos = R_use > T(1e-12);
  const T Rs = pos ? R_use : T(1);
  const T C1 = pos ? (T(1) / Rs) * (T(1) - (-v) / rr) : T(0);
  const T dR_re = k2 * (-(C1 + k * i1));
  const T dR_im = k2 * (T(kPi) * k * eY * J1);
  const bool posR = R > T(1e-12);
  const T R0 = posR ? R : T(1);
  const T ux = diag_lid ? T(1) : (posR ? dx / R0 : T(0));
  const T uy = diag_lid ? T(0) : (posR ? dy / R0 : T(0));
  gx.re = dR_re * ux;
  gx.im = dR_im * ux;
  gy.re = dR_re * uy;
  gy.im = dR_im * uy;
}

template <typename T>
__device__ void wave_fd(T k0, T A0, const T* lam, const T* afit, int nl, double h, T R,
                        T dx, T dy, T zP, T zQ, T area_j, bool diag_lid, const Table<T>& tab,
                        Cplx<T>& G, Cplx<T>& gx, Cplx<T>& gy, Cplx<T>& gz) {
  const T R_eff = T(0.4) * sqrt(fmax(area_j, T(1e-14)));
  const T R_use = diag_lid ? R_eff : R;
  const T h2 = T(2.0 * h), h4 = T(4.0 * h);
  const T d4[4] = {-(zP + zQ), h2 - (zP - zQ), h2 + (zP - zQ), h4 + (zP + zQ)};
  const T sgn[4] = {T(-1), T(-1), T(1), T(1)};
  const T X = k0 * R_use;
  const T J0 = bessel_j0(X);
  const T J1 = bessel_j1(X);
  const T R2 = R_use * R_use;
  T gre = T(0), gre_R = T(0), gre_z = T(0);
#pragma unroll
  for (int i = 1; i < 4; ++i) {             // the "1" parts of images 2..4
    const T rr2 = fmax(R2 + d4[i] * d4[i], T(1e-12));
    const T rr = sqrt(rr2);
    const T t3 = T(1) / (rr2 * rr);
    const T tg = T(1) / rr, tR = (-R_use) * t3, tz = (-d4[i]) * t3 * sgn[i];
    gre = i == 1 ? tg : gre + tg;
    gre_R = i == 1 ? tR : gre_R + tR;
    gre_z = i == 1 ? tz : gre_z + tz;
  }
  const T A2 = T(2) * A0;
  T p0 = T(0), pR = T(0), pz = T(0);
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {             // pole parts: 2 A0 I0(k0 R, -k0 d_i)
    const T Y4 = (-k0) * d4[i];
    T i0, i1;
    wave_integrals(X, Y4, tab, i0, i1);
    const T rxy = sqrt(X * X + Y4 * Y4 + T(1e-20));
    const bool pos = X > T(1e-12);
    const T Xs = pos ? X : T(1);
    const T C1 = pos ? (T(1) / Xs) * (T(1) - (-Y4) / rxy) : T(0);
    const T a0 = A2 * i0;
    const T aR = A2 * k0 * (-(C1 + i1));
    const T az = A2 * ((-k0) * sgn[i]) * (T(1) / rxy + i0);
    p0 = i == 0 ? a0 : p0 + a0;
    pR = i == 0 ? aR : pR + aR;
    pz = i == 0 ? az : pz + az;
  }
  gre = gre + p0;
  gre_R = gre_R + pR;
  gre_z = gre_z + pz;
  T g0 = T(0), gR = T(0), gzz = T(0);
#pragma unroll 1
  for (int m = 0; m < nl; ++m) {            // exponential-fit part
    const T lam_m = lam[m], a_m = afit[m];
    T s0 = T(0), sR = T(0), sz = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T cc = d4[i] + lam_m;
      const T rr2 = fmax(R2 + cc * cc, T(1e-12));
      const T rr = sqrt(rr2);
      const T t3 = a_m / (rr2 * rr);
      const T t0 = a_m / rr, tR = -R_use * t3, tz = -cc * t3 * sgn[i];
      s0 = i == 0 ? t0 : s0 + t0;
      sR = i == 0 ? tR : sR + tR;
      sz = i == 0 ? tz : sz + tz;
    }
    g0 = g0 + s0;
    gR = gR + sR;
    gzz = gzz + sz;
  }
  gre = gre + g0;
  gre_R = gre_R + gR;
  gre_z = gre_z + gzz;
  T gim = T(0), gim_R = T(0), gim_z = T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {             // radiated-wave (imaginary) part
    const T e = exp((-k0) * d4[i]);
    const T t0 = T(-kTwoPi) * A0 * e * J0;
    const T tR = T(kTwoPi) * A0 * k0 * e * J1;
    const T tz = T(kTwoPi) * A0 * k0 * sgn[i] * e * J0;
    gim = i == 0 ? t0 : gim + t0;
    gim_R = i == 0 ? tR : gim_R + tR;
    gim_z = i == 0 ? tz : gim_z + tz;
  }
  const T v2 = zP + zQ + h2;                // seabed image 1/r2
  const T rr2 = fmax(R2 + v2 * v2, T(1e-12));
  const T rr = sqrt(rr2);
  const T t3 = T(1) / (rr2 * rr);
  gre = gre + T(1) / rr;
  gre_R = gre_R - R_use * t3;
  gre_z = gre_z - v2 * t3;
  const bool pos = R_use > T(1e-12);
  const T Rs = pos ? R_use : T(1);
  const T ux = pos ? dx / Rs : T(0);
  const T uy = pos ? dy / Rs : T(0);
  G.re = gre;
  G.im = gim;
  gx.re = gre_R * ux;
  gx.im = gim_R * ux;
  gy.re = gre_R * uy;
  gy.im = gim_R * uy;
  gz.re = gre_z;
  gz.im = gim_z;
}

template <typename T>
__global__ void wave_kernel(const T* __restrict__ Rp, const T* __restrict__ Rdn,
                            const T* __restrict__ c, const T* __restrict__ nrm,
                            const T* __restrict__ area, const T* __restrict__ mask,
                            const T* __restrict__ lids, Table<T> tab,
                            const T* __restrict__ ks, const T* __restrict__ k0s,
                            const T* __restrict__ A0s, const T* __restrict__ active,
                            const T* __restrict__ lam, const T* __restrict__ afit, int nl,
                            int n, int finite_depth, double depth, T* __restrict__ Sre,
                            T* __restrict__ Sim, T* __restrict__ Dre, T* __restrict__ Dim) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int f = blockIdx.z;
  if (i >= n || j >= n) return;
  const T cix = c[3 * i], ciy = c[3 * i + 1], ciz = c[3 * i + 2];
  const T cjx = c[3 * j], cjy = c[3 * j + 1], cjz = c[3 * j + 2];
  const T area_j = area[j];
  const T dx = cix - cjx, dy = ciy - cjy;
  const T R = sqrt(dx * dx + dy * dy + T(1e-20));
  const bool diag_lid = i == j && lids[j] > T(0.5);
  Cplx<T> G, gx, gy, gz;
  if (finite_depth && active[f] > T(0.5)) {
    wave_fd(k0s[f], A0s[f], lam + static_cast<size_t>(f) * nl,
            afit + static_cast<size_t>(f) * nl, nl, depth, R, dx, dy, ciz, cjz, area_j,
            diag_lid, tab, G, gx, gy, gz);
  } else {
    wave_deep(ks[f], R, dx, dy, ciz + cjz, area_j, diag_lid, tab, G, gx, gy, gz);
  }
  const T m = mask[j];
  const T n0 = nrm[3 * i], n1 = nrm[3 * i + 1], n2 = nrm[3 * i + 2];
  const size_t ij = static_cast<size_t>(i) * n + j;
  const size_t o = static_cast<size_t>(f) * n * n + ij;
  Sre[o] = (Rp[ij] + G.re * area_j) * m;
  Sim[o] = (G.im * area_j) * m;
  const T proj_re = gx.re * n0 + gy.re * n1 + gz.re * n2;
  const T proj_im = gx.im * n0 + gy.im * n1 + gz.im * n2;
  Dre[o] = (Rdn[ij] + proj_re * area_j) * m;
  Dim[o] = (proj_im * area_j) * m;
}

template <typename T>
int launch(const void* Rp, const void* Rdn, const void* c, const void* nrm, const void* area,
           const void* mask, const void* lids, const void* I0, const void* I1,
           const void* glx, const void* glw, long long nx, long long ns, double xmax,
           double smax, const void* ks, const void* k0s, const void* A0s, const void* active,
           const void* lam, const void* afit, long long nl, long long n, long long nf,
           long long finite_depth, double depth, void* Sre, void* Sim, void* Dre, void* Dim,
           void* stream) {
  Table<T> tab;
  tab.I0 = static_cast<const T*>(I0);
  tab.I1 = static_cast<const T*>(I1);
  tab.glx = static_cast<const T*>(glx);
  tab.glw = static_cast<const T*>(glw);
  tab.nx = static_cast<int>(nx);
  tab.ns = static_cast<int>(ns);
  tab.xmax = T(xmax);
  tab.smax = T(smax);
  tab.fx_div = T(xmax / static_cast<double>(nx - 1));
  tab.fs_div = T(smax / static_cast<double>(ns - 1));
  tab.far_thr = T(xmax * (1.0 - 1e-7));
  tab.deep_thr = T(smax * (1.0 - 1e-7));
  const dim3 block(64, 4);
  const dim3 grid(static_cast<unsigned>((n + 63) / 64), static_cast<unsigned>((n + 3) / 4),
                  static_cast<unsigned>(nf));
  wave_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Rp), static_cast<const T*>(Rdn), static_cast<const T*>(c),
      static_cast<const T*>(nrm), static_cast<const T*>(area), static_cast<const T*>(mask),
      static_cast<const T*>(lids), tab, static_cast<const T*>(ks), static_cast<const T*>(k0s),
      static_cast<const T*>(A0s), static_cast<const T*>(active), static_cast<const T*>(lam),
      static_cast<const T*>(afit), static_cast<int>(nl), static_cast<int>(n),
      static_cast<int>(finite_depth), depth, static_cast<T*>(Sre), static_cast<T*>(Sim),
      static_cast<T*>(Dre), static_cast<T*>(Dim));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define BEM_WAVE_ARGS                                                                        \
  const void *Rp, const void *Rdn, const void *c, const void *nrm, const void *area,        \
      const void *mask, const void *lids, const void *I0, const void *I1, const void *glx,  \
      const void *glw, long long nx, long long ns, double xmax, double smax, const void *ks, \
      const void *k0s, const void *A0s, const void *active, const void *lam,                 \
      const void *afit, long long nl, long long n, long long nf, long long finite_depth,     \
      double depth, void *Sre, void *Sim, void *Dre, void *Dim, void *stream
#define BEM_WAVE_PASS                                                                    \
  Rp, Rdn, c, nrm, area, mask, lids, I0, I1, glx, glw, nx, ns, xmax, smax, ks, k0s, A0s, \
      active, lam, afit, nl, n, nf, finite_depth, depth, Sre, Sim, Dre, Dim, stream

int bem_wave_f32(BEM_WAVE_ARGS) { return launch<float>(BEM_WAVE_PASS); }
int bem_wave_f64(BEM_WAVE_ARGS) { return launch<double>(BEM_WAVE_PASS); }

}  // extern "C"
