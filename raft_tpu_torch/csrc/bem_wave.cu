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
// The plain version is raft_tpu_torch/hydro/torch_bem.py::wave_plain.
//
// What bounds it on an H100.  Deep-water frequencies read two and write
// four n x n planes per frequency and do a few hundred operations per pair,
// except the near pairs; finite-depth frequencies do four images' wave
// integrals and 46 x 4 fit terms per pair.  The chunks are bound by
// operations, in f64 at 34 TFLOP/s.  The first version (one thread per
// pair) ran 0.27-8.9 ms per chunk of the 1,024-panel staging grid: at low
// frequency in 200 m almost every image is near, and each of its 16 nodes
// paid 44 f64 divisions in the series, an exp, a cos and a sin; the fit
// paid a sqrt and two divisions per term and image; and a warp whose 32
// pairs took different regions waited for its slowest lane.
//
// Design.
//   * Near quadrature: the E1 series is a degree-12 complex Horner
//     polynomial in zeta with coefficients (-1)^(m+1) / (m m!), staged by
//     the wrapper with sin(theta_q) and w_q pi / 2 of the 16 nodes; no
//     division but one 1/|zeta|^2 per node and image.  e^Y is taken once
//     per image (and is the radiated part's e^(-k0 d_i) too), and
//     sincos(X sin(theta_q)) once per node for all four images, which
//     share X = k0 R.
//   * Warp-uniform near work: each lane marks its pair's near images, and
//     the warp then works through the pairs that have any, two at a time,
//     a half-warp each, one node per lane; a shuffle sum over the 16 lanes
//     gives the pair's two node sums, which its own lane picks up from
//     shared memory.  Images in the other regions take their branch per
//     lane (a few dozen operations).
//   * Exponential fit: one rsqrt per term and image gives a/r and a/r^3;
//     lam and a of the block's frequencies sit in shared memory.
//   * Frequencies: each thread loops over up to 8 frequencies of the chunk,
//     so the geometry, normals, R_pot and R_dn are read once and the pair's
//     unit vector is divided out once.  A warp is 32
//     consecutive source panels j of one field panel i, so loads and the
//     four stores per frequency are contiguous.
//   * The two 900 x 200 tables (1.44 MB each in f64) do not fit shared
//     memory; they are read through L2 with __ldg.  The Bessel functions
//     are the polynomial approximations of raft_tpu_torch/core/bessel.py.
// Built without -fmad=false (the first version had it): the compiler may
// fuse products and sums, except where the region of a pair is decided
// (R, rho), which rounds each operation as the plain version does, so
// every pair takes the plain version's region.
//
// Storage and arithmetic types are separate template arguments (S, T): f64
// and f32 store and compute in one type; the bf16 entry
// (RAFT_TPU_BEM_PRECISION=bf16: R_pot, R_dn, the geometry, the tables, the
// node tables, k and the fit arrays all in bf16, as the JAX package passes
// them) loads __nv_bfloat16, computes in float and rounds each of the four
// outputs once with __float2bfloat16_rn, the plain version's bf16 (upcast,
// compute in float32, round).  Hopper's bf16 arithmetic is paired FMA
// without transcendental units, so the log, atan2, exp, sincos and rsqrt
// stay float.  The shared-memory arrays (series coefficients, fit terms,
// node sums) hold the arithmetic type: they are read in every inner loop
// and converted once when staged.  What bf16 saves is bytes: the two n x n
// inputs and the four nf x n x n outputs at half of f32's size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kEuler = 0.5772156649015329;
constexpr double k2OverPi = 0.636619772367581343;
constexpr double kRNear = 0.6;
constexpr int kNSeries = 12;                // E1 series terms
constexpr int kNodes = 16;                  // near-quadrature nodes
constexpr int kWarps = 4;                   // warps per block: field panels of a tile
constexpr int kFreqBlock = 8;               // frequencies per block
constexpr int kMaxNL = 64;                  // exponential-fit terms, at most
constexpr unsigned kFull = 0xffffffffu;

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

// products and sums rounded one at a time, as PyTorch's elementwise
// operations round them: the quantities that choose a pair's region
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ void sin_cos(double x, double& s, double& c) { sincos(x, &s, &c); }
__device__ __forceinline__ void sin_cos(float x, float& s, float& c) { sincosf(x, &s, &c); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }

// storage -> arithmetic type (bf16 is computed in float), the read-only
// cached load, and the store back
__device__ __forceinline__ double up(double x) { return x; }
__device__ __forceinline__ float up(float x) { return x; }
__device__ __forceinline__ float up(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double ldg(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
__device__ __forceinline__ void store(double* p, double x) { *p = x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename S, typename T>
struct Table {
  const S* I0;
  const S* I1;
  int nx, ns;
  T xmax, smax, fx_div, fs_div, far_thr, deep_thr;
};

// rho = |(X, Y)| as the plain version rounds it: rho < R_NEAR is the near region
template <typename T>
__device__ __forceinline__ bool is_near(T X, T Y) {
  return sqrt(add_rn(add_rn(mul_rn(X, X), mul_rn(Y, Y)), T(1e-18))) < T(kRNear);
}

// One node of the near quadrature at zeta = zr + i zi, without the e^zr
// factor: (E1(zeta) + i pi) e^(i zi) as (phr, phi), and 1 / |zeta|^2.
// cr, ci = cos(zi), sin(zi); coef: the series' Horner coefficients.
template <typename T>
__device__ __forceinline__ void near_node(T zr, T zi, T cr, T ci, const T* coef, T& phr,
                                          T& phi, T& inv) {
  T az2 = zr * zr + zi * zi;
  az2 = fmax(az2, T(1e-14));
  const T log_re = T(0.5) * log(az2);
  const T log_im = atan2(zi, zr);
  T pr = coef[kNSeries - 1], pim = T(0);
#pragma unroll
  for (int m = kNSeries - 2; m >= 0; --m) {
    const T tr = pr * zr - pim * zi + coef[m];
    const T ti = pr * zi + pim * zr;
    pr = tr;
    pim = ti;
  }
  const T sr = pr * zr - pim * zi;
  const T si = pr * zi + pim * zr;
  const T e1r = T(-kEuler) - log_re + sr;
  const T e1i = -log_im + si;
  phr = cr * e1r - ci * (e1i + T(kPi));
  phi = cr * (e1i + T(kPi)) + ci * e1r;
  inv = T(1) / az2;
}

// The near quadrature of up to NI images of every lane's pair, by the whole
// warp: bit m of `mask` marks image m of this lane's pair as near (X, Y[m])
// with ez[m] = e^Y[m].  Pairs with any near image are taken two at a time,
// a half-warp each, lane q of the half on node q; the node sums
// sum_q w_q phr_q (without e^Y) and sum_q w_q s_q dPhi_q go to acc[lane][m].
template <typename T, int NI>
__device__ void near_pass(T X, const T (&Y)[NI], const T (&ez)[NI], unsigned mask, T s_q, T w_q,
                          T ws_q, const T* coef, T (*acc)[4][2]) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  unsigned todo = __ballot_sync(kFull, mask != 0u);
  while (todo) {
    const int L0 = __ffs(todo) - 1;
    todo &= todo - 1;
    int L1 = -1;
    if (todo) {
      L1 = __ffs(todo) - 1;
      todo &= todo - 1;
    }
    const int L = half ? L1 : L0;
    const int src = L < 0 ? L0 : L;
    const T Xl = __shfl_sync(kFull, X, src);
    unsigned ml = __shfl_sync(kFull, mask, src);
    if (L < 0) ml = 0u;
    const unsigned both = ml | __shfl_xor_sync(kFull, ml, 16);
    const T zi = Xl * s_q;
    T sn, cs;
    sin_cos(zi, sn, cs);
#pragma unroll
    for (int m = 0; m < NI; ++m) {
      const T Yl = __shfl_sync(kFull, Y[m], src);
      const T el = __shfl_sync(kFull, ez[m], src);
      if (!(both & (1u << m))) continue;     // the same on every lane
      T a0 = T(0), aX = T(0);
      if (ml & (1u << m)) {
        T phr, phi, inv;
        near_node(Yl, zi, cs, sn, coef, phr, phi, inv);
        a0 = w_q * phr;
        aX = ws_q * (el * phi + zi * inv);
      }
#pragma unroll
      for (int off = kNodes / 2; off > 0; off >>= 1) {
        a0 = a0 + __shfl_xor_sync(kFull, a0, off);
        aX = aX + __shfl_xor_sync(kFull, aX, off);
      }
      if ((lane & (kNodes - 1)) == 0 && (ml & (1u << m))) {
        acc[L][m][0] = a0;
        acc[L][m][1] = aX;
      }
    }
  }
  __syncwarp();
}

// (I0, I1) of a near image from its node sums
template <typename T>
__device__ __forceinline__ void near_finish(T X, T Y, T ez, const T (&a)[2], T& i0, T& i1) {
  i0 = (ez * a[0]) / T(kPi);
  const T dI0_dX = -a[1] / T(kPi);
  const T rr = sqrt(fmax(X * X + Y * Y, T(1e-14)));
  const bool pos = X > T(1e-9);
  const T xs = pos ? X : T(1);
  const T C1 = pos ? (T(1) / xs) * (T(1) - (-Y) / rr) : T(0);
  i1 = pos ? -C1 - dI0_dX : T(0);
}

// (I0, I1) at X >= 0, Y <= 0 outside the near region: table, far or deep
template <typename S, typename T>
__device__ void region_integrals(T X, T Y, const Table<S, T>& tab, T& i0, T& i1) {
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
    const T rr = fmax(sqrt(X * X + Y * Y + T(1e-18)), T(1e-30));
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
  const S* I0 = tab.I0;
  const S* I1 = tab.I1;
  const T l0 = (T(1) - tx) * ((T(1) - ts) * ldg(I0 + o) + ts * ldg(I0 + o + 1))
               + tx * ((T(1) - ts) * ldg(I0 + o + tab.ns) + ts * ldg(I0 + o + tab.ns + 1));
  const T l1 = (T(1) - tx) * ((T(1) - ts) * ldg(I1 + o) + ts * ldg(I1 + o + 1))
               + tx * ((T(1) - ts) * ldg(I1 + o + tab.ns) + ts * ldg(I1 + o + tab.ns + 1));
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

// What a lane needs of its pair and its near-quadrature node
template <typename T>
struct Pair {
  T R, R_use, dx, dy, zP, zQ;
  T ux_deep, uy_deep, ux_fd, uy_fd;   // the horizontal unit vector of each branch
  bool diag_lid, live;
  T s_q, w_q, ws_q;           // node q = lane % 16: sin(theta_q), w_q pi / 2, product
  const T* coef;              // Horner coefficients (shared memory)
  T (*acc)[4][2];             // this warp's node sums (shared memory)
};

template <typename S, typename T>
__device__ void wave_deep(T k, const Pair<T>& p, const Table<S, T>& tab, Cplx<T>& G, Cplx<T>& gx,
                          Cplx<T>& gy, Cplx<T>& gz) {
  const T R_use = p.R_use;
  const T v = p.zP + p.zQ;
  const T X = k * R_use;
  const T Y[1] = {k * v};
  const T eY[1] = {exp(Y[0])};
  const bool near = p.live && is_near(X, Y[0]);
  near_pass<T, 1>(X, Y, eY, near ? 1u : 0u, p.s_q, p.w_q, p.ws_q, p.coef, p.acc);
  T i0, i1;
  if (near) {
    near_finish(X, Y[0], eY[0], p.acc[threadIdx.x & 31][0], i0, i1);
  } else {
    region_integrals(X, Y[0], tab, i0, i1);
  }
  const T J0 = bessel_j0(X);
  const T J1 = bessel_j1(X);
  const T k2 = T(2) * k;
  G.re = k2 * i0;
  G.im = k2 * (T(-kPi) * eY[0] * J0);
  const T rr = sqrt(R_use * R_use + v * v + T(1e-20));
  gz.re = k2 * (T(1) / rr + k * i0);
  gz.im = k2 * (T(-kPi) * k * eY[0] * J0);
  const bool pos = R_use > T(1e-12);
  const T Rs = pos ? R_use : T(1);
  const T C1 = pos ? (T(1) / Rs) * (T(1) - (-v) / rr) : T(0);
  const T dR_re = k2 * (-(C1 + k * i1));
  const T dR_im = k2 * (T(kPi) * k * eY[0] * J1);
  gx.re = dR_re * p.ux_deep;
  gx.im = dR_im * p.ux_deep;
  gy.re = dR_re * p.uy_deep;
  gy.im = dR_im * p.uy_deep;
}

template <typename S, typename T>
__device__ void wave_fd(T k0, T A0, const T* lam, const T* afit, int nl, double h,
                        const Pair<T>& p, const Table<S, T>& tab, Cplx<T>& G, Cplx<T>& gx,
                        Cplx<T>& gy, Cplx<T>& gz) {
  const T R_use = p.R_use, zP = p.zP, zQ = p.zQ;
  const T h2 = T(2.0 * h), h4 = T(4.0 * h);
  const T d4[4] = {-(zP + zQ), h2 - (zP - zQ), h2 + (zP - zQ), h4 + (zP + zQ)};
  const T sgn[4] = {T(-1), T(-1), T(1), T(1)};
  const T X = k0 * R_use;
  T Y4[4], e4[4];
  unsigned near = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    Y4[i] = (-k0) * d4[i];
    e4[i] = exp(Y4[i]);                 // e^Y: the near quadrature and the radiated part
    if (p.live && is_near(X, Y4[i])) near |= 1u << i;
  }
  near_pass<T, 4>(X, Y4, e4, near, p.s_q, p.w_q, p.ws_q, p.coef, p.acc);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {             // pole parts: 2 A0 I0(k0 R, -k0 d_i)
    T i0, i1;
    if (near & (1u << i)) {
      near_finish(X, Y4[i], e4[i], p.acc[threadIdx.x & 31][i], i0, i1);
    } else {
      region_integrals(X, Y4[i], tab, i0, i1);
    }
    const T rxy = sqrt(X * X + Y4[i] * Y4[i] + T(1e-20));
    const bool pos = X > T(1e-12);
    const T Xs = pos ? X : T(1);
    const T C1 = pos ? (T(1) / Xs) * (T(1) - (-Y4[i]) / rxy) : T(0);
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
#pragma unroll 2
  for (int m = 0; m < nl; ++m) {            // exponential-fit part
    const T lam_m = lam[m], a_m = afit[m];
    T s0 = T(0), sR = T(0), sz = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T cc = d4[i] + lam_m;
      const T ri = rsqrt_(fmax(R2 + cc * cc, T(1e-12)));
      const T t0 = a_m * ri;                // a / r
      const T t3 = t0 * (ri * ri);          // a / r^3
      const T tR = -R_use * t3, tz = -cc * t3 * sgn[i];
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
    const T e = e4[i];
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
  G.re = gre;
  G.im = gim;
  gx.re = gre_R * p.ux_fd;
  gx.im = gim_R * p.ux_fd;
  gy.re = gre_R * p.uy_fd;
  gy.im = gim_R * p.uy_fd;
  gz.re = gre_z;
  gz.im = gim_z;
}

template <typename S, typename T>
__global__ void __launch_bounds__(32 * kWarps)
wave_kernel(const S* __restrict__ Rp, const S* __restrict__ Rdn, const S* __restrict__ c,
            const S* __restrict__ nrm, const S* __restrict__ area, const S* __restrict__ mask,
            const S* __restrict__ lids, Table<S, T> tab, const S* __restrict__ node_s,
            const S* __restrict__ node_w, const S* __restrict__ coef,
            const S* __restrict__ ks, const S* __restrict__ k0s, const S* __restrict__ A0s,
            const S* __restrict__ active, const S* __restrict__ lam,
            const S* __restrict__ afit, int nl, int n, int nf, int finite_depth,
            double depth, S* __restrict__ Sre, S* __restrict__ Sim, S* __restrict__ Dre,
            S* __restrict__ Dim) {
  __shared__ T s_coef[kNSeries];
  __shared__ T s_lam[kFreqBlock * kMaxNL];
  __shared__ T s_afit[kFreqBlock * kMaxNL];
  __shared__ T s_acc[kWarps][32][4][2];
  const int f0 = blockIdx.z * kFreqBlock;
  const int nfb = min(kFreqBlock, nf - f0);
  const int tid = threadIdx.y * 32 + threadIdx.x;
  if (tid < kNSeries) s_coef[tid] = up(coef[tid]);
  if (finite_depth) {
    for (int e = tid; e < nfb * nl; e += 32 * kWarps) {
      const int f = e / nl, m = e % nl;
      s_lam[f * kMaxNL + m] = up(lam[static_cast<size_t>(f0 + f) * nl + m]);
      s_afit[f * kMaxNL + m] = up(afit[static_cast<size_t>(f0 + f) * nl + m]);
    }
  }
  __syncthreads();

  // every lane stays to the end (the near pass is warp-wide): lanes off
  // the pair grid compute a clamped pair, mark nothing near, store nothing
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int i = blockIdx.y * kWarps + threadIdx.y;
  const int ic = min(i, n - 1), jc = min(j, n - 1);
  Pair<T> p;
  p.live = i < n && j < n;
  const T cix = up(c[3 * ic]), ciy = up(c[3 * ic + 1]);
  const T cjx = up(c[3 * jc]), cjy = up(c[3 * jc + 1]);
  p.zP = up(c[3 * ic + 2]);
  p.zQ = up(c[3 * jc + 2]);
  const T area_j = up(area[jc]);
  p.dx = cix - cjx;
  p.dy = ciy - cjy;
  p.R = sqrt(add_rn(add_rn(mul_rn(p.dx, p.dx), mul_rn(p.dy, p.dy)), T(1e-20)));
  p.diag_lid = ic == jc && up(lids[jc]) > T(0.5);
  const T R_eff = T(0.4) * sqrt(fmax(area_j, T(1e-14)));
  p.R_use = p.diag_lid ? R_eff : p.R;
  const bool posR = p.R > T(1e-12), posU = p.R_use > T(1e-12);
  const T R0 = posR ? p.R : T(1), Rs = posU ? p.R_use : T(1);
  p.ux_deep = p.diag_lid ? T(1) : (posR ? p.dx / R0 : T(0));
  p.uy_deep = p.diag_lid ? T(0) : (posR ? p.dy / R0 : T(0));
  p.ux_fd = posU ? p.dx / Rs : T(0);
  p.uy_fd = posU ? p.dy / Rs : T(0);
  const int q = threadIdx.x & (kNodes - 1);
  p.s_q = up(node_s[q]);
  p.w_q = up(node_w[q]);
  p.ws_q = p.w_q * p.s_q;
  p.coef = s_coef;
  p.acc = s_acc[threadIdx.y];
  const T m = up(mask[jc]);
  const T n0 = up(nrm[3 * ic]), n1 = up(nrm[3 * ic + 1]), n2 = up(nrm[3 * ic + 2]);
  const size_t ij = static_cast<size_t>(ic) * n + jc;
  const T rp = up(Rp[ij]), rdn = up(Rdn[ij]);
#pragma unroll 1
  for (int fl = 0; fl < nfb; ++fl) {
    const int f = f0 + fl;
    Cplx<T> G, gx, gy, gz;
    if (finite_depth && up(active[f]) > T(0.5)) {
      wave_fd(up(k0s[f]), up(A0s[f]), s_lam + fl * kMaxNL, s_afit + fl * kMaxNL, nl, depth, p,
              tab, G, gx, gy, gz);
    } else {
      wave_deep(up(ks[f]), p, tab, G, gx, gy, gz);
    }
    if (p.live) {
      const size_t o = static_cast<size_t>(f) * n * n + ij;
      store(Sre + o, (rp + G.re * area_j) * m);
      store(Sim + o, (G.im * area_j) * m);
      const T proj_re = gx.re * n0 + gy.re * n1 + gz.re * n2;
      const T proj_im = gx.im * n0 + gy.im * n1 + gz.im * n2;
      store(Dre + o, (rdn + proj_re * area_j) * m);
      store(Dim + o, (proj_im * area_j) * m);
    }
  }
}

template <typename S, typename T>
int launch(const void* Rp, const void* Rdn, const void* c, const void* nrm, const void* area,
           const void* mask, const void* lids, const void* I0, const void* I1,
           const void* node_s, const void* node_w, const void* coef, long long nx,
           long long ns, double xmax, double smax, const void* ks, const void* k0s,
           const void* A0s, const void* active, const void* lam, const void* afit, long long nl,
           long long n, long long nf, long long finite_depth, double depth, void* Sre,
           void* Sim, void* Dre, void* Dim, void* stream) {
  if (nl > kMaxNL) return static_cast<int>(cudaErrorInvalidValue);
  Table<S, T> tab;
  tab.I0 = static_cast<const S*>(I0);
  tab.I1 = static_cast<const S*>(I1);
  tab.nx = static_cast<int>(nx);
  tab.ns = static_cast<int>(ns);
  tab.xmax = T(xmax);
  tab.smax = T(smax);
  tab.fx_div = T(xmax / static_cast<double>(nx - 1));
  tab.fs_div = T(smax / static_cast<double>(ns - 1));
  tab.far_thr = T(xmax * (1.0 - 1e-7));
  tab.deep_thr = T(smax * (1.0 - 1e-7));
  const dim3 block(32, kWarps);
  const dim3 grid(static_cast<unsigned>((n + 31) / 32),
                  static_cast<unsigned>((n + kWarps - 1) / kWarps),
                  static_cast<unsigned>((nf + kFreqBlock - 1) / kFreqBlock));
  wave_kernel<S, T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(Rp), static_cast<const S*>(Rdn), static_cast<const S*>(c),
      static_cast<const S*>(nrm), static_cast<const S*>(area), static_cast<const S*>(mask),
      static_cast<const S*>(lids), tab, static_cast<const S*>(node_s),
      static_cast<const S*>(node_w), static_cast<const S*>(coef), static_cast<const S*>(ks),
      static_cast<const S*>(k0s), static_cast<const S*>(A0s), static_cast<const S*>(active),
      static_cast<const S*>(lam), static_cast<const S*>(afit), static_cast<int>(nl),
      static_cast<int>(n), static_cast<int>(nf), static_cast<int>(finite_depth), depth,
      static_cast<S*>(Sre), static_cast<S*>(Sim), static_cast<S*>(Dre), static_cast<S*>(Dim));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define BEM_WAVE_ARGS                                                                         \
  const void *Rp, const void *Rdn, const void *c, const void *nrm, const void *area,         \
      const void *mask, const void *lids, const void *I0, const void *I1,                    \
      const void *node_s, const void *node_w, const void *coef, long long nx, long long ns,  \
      double xmax, double smax, const void *ks, const void *k0s, const void *A0s,            \
      const void *active, const void *lam, const void *afit, long long nl, long long n,      \
      long long nf, long long finite_depth, double depth, void *Sre, void *Sim, void *Dre,   \
      void *Dim, void *stream
#define BEM_WAVE_PASS                                                                      \
  Rp, Rdn, c, nrm, area, mask, lids, I0, I1, node_s, node_w, coef, nx, ns, xmax, smax, ks, \
      k0s, A0s, active, lam, afit, nl, n, nf, finite_depth, depth, Sre, Sim, Dre, Dim, stream

int bem_wave_f32(BEM_WAVE_ARGS) { return launch<float, float>(BEM_WAVE_PASS); }
int bem_wave_f64(BEM_WAVE_ARGS) { return launch<double, double>(BEM_WAVE_PASS); }
int bem_wave_bf16(BEM_WAVE_ARGS) { return launch<__nv_bfloat16, float>(BEM_WAVE_PASS); }

}  // extern "C"
