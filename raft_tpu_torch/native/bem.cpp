// Native frequency-domain panel-method BEM solver (HAMS-equivalent), the
// host C++ solver of raft_tpu_torch (BEM="native").
//
// The port's own copy of the JAX package's solver (raft_tpu/native/bem.cpp):
// the physics and the C API are the same, so both give the same numbers on
// the same host.  Two places differ.  The wave-integral table's disk cache
// lives where the caller says (bem_set_table_path, called by the ctypes
// wrapper raft_tpu_torch/hydro/native_bem.py with a file under
// raft_tpu_torch/_build/), not under $HOME; without a path the table is
// built in memory only.  And the table file is published atomically (a
// temporary file in the same directory, then rename), so processes that
// build it at once never read a torn file.
//
// A constant-strength source (Hess & Smith) panel method with the
// deep-water and finite-depth free-surface Green functions, OpenMP-threaded
// over panel pairs.  Given a hull panel mesh and a frequency grid it returns
// potential-flow added mass A(w), radiation damping B(w) and wave excitation
// X(w), which are staged to the torch pipeline (Model(BEM=(A, B, F))).
//
// Method
// ------
// Green function, infinite depth, e^{i w t} time convention
// (Wehausen & Laitone eq. 13.17):
//   G(P,Q) = 1/r + 1/r1 + Gf,
//   Gf     = 2k * [ I0(X, Y) - i pi e^Y J0(X) ],
// with r the direct distance, r1 the distance to the free-surface image of
// Q, k = w^2/g, X = k*R (horizontal), Y = k*(z+zeta) <= 0, and
//   I0(X,Y) = PV Int_0^inf e^{uY} J0(uX) / (u-1) du,
// the dimensionless principal-value wave integral (u = kappa/k).  I0 and
// its J1 counterpart I1 are precomputed once on a 2-D table over
// (X, log(1-Y)) and bilinearly interpolated -- the Delhommeau-table
// strategy used by established BEM codes; direct evaluation uses pole
// subtraction on [0,2] plus Bessel-zero-segmented tail quadrature.
//
// Derivatives (for the source boundary condition) use the identities
//   dI0/dY' = 1/sqrt(X^2+Y^2)_scaled + I0           (no new integral)
//   dI0/dX  = -[ C1(X,Y) + I1(X,Y) ],  C1 = (1/X)(1 - (-Y)/sqrt(X^2+Y^2))
//
// Radiation problem k=1..6:  (2 pi I + D) sigma = n_k    (source strengths)
// Diffraction:               (2 pi I + D) sigma = -d(phi_I)/dn
// with D_ij the normal-derivative influence of panel j at collocation i
// (Rankine parts integrated with Gauss subdivision near the singularity and
// the exact flat-polygon formula for the self term), then
//   phi = S sigma,   A - iB/w = rho Int phi_k n_j dS   (radiation)
//   X_j = -i w rho Int (phi_I + phi_S) n_j dS          (excitation)
//
// Validation: reference HAMS outputs for the 1008-panel cylinder
// (raft/data/cylinder/Output/Wamit_format/Buoy.1/.3) and Hulme's analytic
// hemisphere coefficients -- see tests/test_torch_native_bem.py.
#include <cmath>
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#endif

using cdouble = std::complex<double>;
static const double PI = 3.14159265358979323846;

// ----------------------------------------------------------------- tables
//
// The tables store the SMOOTH parts of the wave integrals: near X=Y=0 the
// integrals behave like  I0 ~ -ln(rho) ,  I1 ~ -C1 + X/rho^2  with
// rho = sqrt(X^2+Y^2), C1 = (1/X)(1 - (-Y)/rho); subtracting those closed
// forms makes bilinear interpolation accurate everywhere.

static inline double sing_I0(double X, double Y) {
    return -0.5 * log(X * X + Y * Y);
}
static inline double sing_I1(double X, double Y) {
    double r2 = X * X + Y * Y;
    double C1 = X > 1e-12 ? (1.0 / X) * (1.0 - (-Y) / sqrt(r2)) : 0.0;
    return -C1 + X / r2;
}

struct WaveTable {
    // X grid: uniform [0, XMAX]; Y grid: s = log(1 - Y) uniform [0, SMAX]
    static constexpr double XMAX = 60.0;
    static constexpr double SMAX = 4.1108738641733;   // log(1+60)
    static constexpr int NX = 1600;
    static constexpr int NS = 320;
    std::vector<double> I0, I1;                        // smooth parts, NX*NS
    bool built = false;

    static double direct_I(double X, double Y, int order);
    void build();
    void eval(double X, double Y, double* i0, double* i1) const;
};

static double gauss_x64[32], gauss_w64[32];            // 64-pt GL half nodes
static void init_gauss64() {
    // 64-point Gauss-Legendre nodes/weights on [-1,1] via Newton iteration
    static bool done = false;
    if (done) return;
    int n = 64;
    for (int i = 0; i < n / 2; i++) {
        double x = cos(PI * (i + 0.75) / (n + 0.5));
        for (int it = 0; it < 100; it++) {
            double p0 = 1.0, p1 = 0.0;
            for (int j = 0; j < n; j++) {
                double p2 = p1; p1 = p0;
                p0 = ((2.0 * j + 1.0) * x * p1 - j * p2) / (j + 1.0);
            }
            double dp = n * (x * p0 - p1) / (x * x - 1.0);
            double dx = -p0 / dp;
            x += dx;
            if (fabs(dx) < 1e-15) break;
        }
        double p0 = 1.0, p1 = 0.0;
        for (int j = 0; j < n; j++) {
            double p2 = p1; p1 = p0;
            p0 = ((2.0 * j + 1.0) * x * p1 - j * p2) / (j + 1.0);
        }
        double dp = n * (x * p0 - p1) / (x * x - 1.0);
        gauss_x64[i] = x;
        gauss_w64[i] = 2.0 / ((1.0 - x * x) * dp * dp);
    }
    done = true;
}

static inline double bess(int order, double x) {
    return order == 0 ? j0(x) : j1(x);
}

// ---------------------------------------------------- complex E1 and Phi
//
// Phi(zeta) = PV Int_0^inf e^{u zeta} / (u-1) du      (Re zeta <= 0)
//           = e^zeta [ 2 Shi(zeta) + E1(-zeta) ]
// derivation: shift t = u-1; the odd part over [-1,1] is 2 Shi(zeta), the
// tail over [1,inf) is E1(-zeta).  All wave integrals reduce to Phi via
// J0(x) = (1/pi) Int_0^pi cos(x sin th) dth  ->  zeta = Y + i X sin th.

// Phi(zeta) = e^zeta [ E1(zeta) + i pi ]   for Im zeta >= 0
// (from 2 Shi(z) = E1(z) - E1(-z) + i pi, Im z > 0; verified against the
// PV definition with mpmath).  E1 uses the power series for |z| <= 22
// (principal log gives the limit-from-above on the negative-real cut,
// exactly the PV convention needed) and the asymptotic e^{-z}/z series
// beyond.
static cdouble phi_pv(cdouble z) {
    double az = std::abs(z);
    const double EULER = 0.5772156649015329;
    if (az < 1e-14) z = cdouble(-1e-14, 0.0);
    if (az <= 22.0) {
        cdouble sum = 0.0, term = 1.0;
        for (int n = 1; n <= 220; n++) {
            term *= -z / (double)n;
            cdouble add = -term / (double)n;
            sum += add;
            if (std::abs(add) < 1e-17 * (1.0 + std::abs(sum)) && n > 4) break;
        }
        cdouble E1 = -EULER - std::log(z) + sum;
        return std::exp(z) * (E1 + cdouble(0.0, PI));
    }
    // e^z E1(z) ~ (1/z) sum (-1)^n n! / z^n  (truncate at smallest term)
    cdouble acc = 0.0, zp = 1.0 / z;
    double fact = 1.0;
    double prev = 1e300;
    for (int n = 0; n < 20; n++) {
        double mag = fact / pow(az, n + 1);
        if (mag > prev) break;                        // series turned
        prev = mag;
        acc += ((n % 2) ? -fact : fact) * zp;
        zp /= z;
        fact *= (double)(n + 1);
    }
    return acc + std::exp(z) * cdouble(0.0, PI);
}

// exact I0, I1 via the theta reduction (any X >= 0, Y <= 0, not both ~0)
static void analytic_I(double X, double Y, double* i0, double* i1);

static void analytic_I(double X, double Y, double* i0, double* i1) {
    init_gauss64();
    double acc0 = 0.0, accX = 0.0;
    int m = 1 + (int)(X / 20.0);                      // resolve cos(X sin th)
    for (int p = 0; p < m; p++) {
        double a = PI * p / m, b = PI * (p + 1) / m;
        for (int i = 0; i < 32; i++) {
            for (int sgn = -1; sgn <= 1; sgn += 2) {
                double x = sgn * gauss_x64[i];
                double th = 0.5 * (a + b) + 0.5 * (b - a) * x;
                double wgt = gauss_w64[i] * 0.5 * (b - a);
                double s = sin(th);
                cdouble zeta(Y, X * s);
                if (std::abs(zeta) < 1e-14) zeta = cdouble(-1e-14, 0.0);
                cdouble Phi = phi_pv(zeta);
                acc0 += wgt * Phi.real();
                cdouble dPhi = -1.0 / zeta + Phi;     // dPhi/dzeta
                accX += wgt * (dPhi * cdouble(0.0, s)).real();
            }
        }
    }
    *i0 = acc0 / PI;
    double dI0_dX = accX / PI;
    double rr = sqrt(X * X + Y * Y);
    double C1 = X > 1e-9 ? (1.0 / X) * (1.0 - (-Y) / rr) : 0.0;
    *i1 = X > 1e-9 ? (-C1 - dI0_dX) : 0.0;
}

// E1(x) for x > 0 (Abramowitz & Stegun 5.1.53/5.1.56)
static double expint_e1(double x) {
    if (x <= 0) return 0.0;
    if (x < 1.0) {
        double a0 = -0.57721566, a1 = 0.99999193, a2 = -0.24991055,
               a3 = 0.05519968, a4 = -0.00976004, a5 = 0.00107857;
        return -log(x) + a0 + x * (a1 + x * (a2 + x * (a3 + x * (a4 + x * a5))));
    }
    double b1 = 8.5733287401, b2 = 18.0590169730, b3 = 8.6347608925, b4 = 0.2677737343;
    double c1 = 9.5733223454, c2 = 25.6329561486, c3 = 21.0996530827, c4 = 3.9584969228;
    double num = x * x * x * x + b1 * x * x * x + b2 * x * x + b3 * x + b4;
    double den = x * x * x * x + c1 * x * x * x + c2 * x * x + c3 * x + c4;
    return exp(-x) / x * num / den;
}

// PV Int_0^inf e^{uY} J_ord(uX) / (u-1) du, Y <= 0.
double WaveTable::direct_I(double X, double Y, int order) {
    init_gauss64();
    auto f = [&](double u) { return exp(u * Y) * bess(order, u * X); };
    double f1 = f(1.0);
    // [0,2]: pole-subtracted (the PV of 1/(u-1) over [0,2] is zero)
    double core = 0.0;
    for (int i = 0; i < 32; i++) {
        for (int sgn = -1; sgn <= 1; sgn += 2) {
            double x = sgn * gauss_x64[i];           // node in [-1,1]
            double u = 1.0 + x;                      // map to [0,2]
            double g;
            if (fabs(x) < 1e-8) {
                // limit (f(u)-f(1))/(u-1) -> f'(1)
                double h = 1e-5;
                g = (f(1.0 + h) - f(1.0 - h)) / (2 * h);
            } else {
                g = (f(u) - f1) / (u - 1.0);
            }
            core += gauss_w64[i] * g;
        }
    }
    // tail [2, inf)
    double tail = 0.0;
    if (X < 1e-9) {
        // J0 -> 1 (order 0) or J1 -> 0 (order 1)
        if (order == 0) {
            if (Y < -1e-12) tail = exp(Y) * expint_e1(-Y);
            else tail = 0.0;                          // X=0,Y=0 excluded
        }
    } else {
        // integrate between Bessel zeros (approx period pi/X), 16-pt GL per
        // segment, stop when negligible
        init_gauss64();
        double u0 = 2.0;
        double du = PI / X;
        double prev = 1e30;
        for (int seg = 0; seg < 4000; seg++) {
            double u1 = u0 + du;
            double s = 0.0;
            for (int i = 0; i < 32; i++) {
                for (int sgn = -1; sgn <= 1; sgn += 2) {
                    double x = sgn * gauss_x64[i];
                    double u = 0.5 * (u0 + u1) + 0.5 * (u1 - u0) * x;
                    s += gauss_w64[i] * f(u) / (u - 1.0);
                }
            }
            s *= 0.5 * (u1 - u0);
            // alternating-series averaging for the oscillatory part
            tail += s;
            if (fabs(s) < 1e-13 && fabs(prev) < 1e-13) break;
            if (u0 * (-Y) > 35.0) break;              // exponential cutoff
            prev = s;
            u0 = u1;
        }
    }
    return core + tail;
}

// the table's disk cache, set by bem_set_table_path; empty: memory only
static char g_table_path[4096] = {0};

static const char* table_cache_path() {
    return g_table_path[0] ? g_table_path : nullptr;
}

// write the table to a temporary file beside ``path`` and rename it into
// place: a reader sees the old file, no file, or the whole new one
static void publish_table(const char* path, const std::vector<double>& I0,
                          const std::vector<double>& I1, int nx, int ns) {
    char tmp[4200];
    snprintf(tmp, sizeof(tmp), "%s.XXXXXX", path);
    int fd = mkstemp(tmp);
    if (fd < 0) return;
    FILE* f = fdopen(fd, "wb");
    if (!f) { close(fd); unlink(tmp); return; }
    int hdr[2] = {nx, ns};
    bool ok = fwrite(hdr, sizeof(int), 2, f) == 2;
    ok = ok && fwrite(I0.data(), sizeof(double), I0.size(), f) == I0.size();
    ok = ok && fwrite(I1.data(), sizeof(double), I1.size(), f) == I1.size();
    ok = (fclose(f) == 0) && ok;
    if (!ok || rename(tmp, path) != 0) unlink(tmp);
}

void WaveTable::build() {
    if (built) return;
    I0.assign((size_t)NX * NS, 0.0);
    I1.assign((size_t)NX * NS, 0.0);
    // disk cache: the table is design-independent, build once per machine
    const char* path = table_cache_path();
    FILE* f = path ? fopen(path, "rb") : nullptr;
    if (f) {
        int hdr[2] = {0, 0};
        bool ok = fread(hdr, sizeof(int), 2, f) == 2 && hdr[0] == NX && hdr[1] == NS;
        ok = ok && fread(I0.data(), sizeof(double), I0.size(), f) == I0.size();
        ok = ok && fread(I1.data(), sizeof(double), I1.size(), f) == I1.size();
        fclose(f);
        if (ok) { built = true; return; }
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int ix = 0; ix < NX; ix++) {
        double X = XMAX * ix / (NX - 1);
        for (int is = 0; is < NS; is++) {
            double s = SMAX * is / (NS - 1);
            double Y = 1.0 - exp(s);                 // 0 .. -60
            if (ix == 0 && is == 0) Y = -1e-6;       // avoid the X=Y=0 corner
            double a0, a1;
            analytic_I(X, Y, &a0, &a1);
            I0[(size_t)ix * NS + is] = a0 - sing_I0(X, Y);
            I1[(size_t)ix * NS + is] = a1 - sing_I1(X, Y);
        }
    }
    if (path) publish_table(path, I0, I1, NX, NS);
    built = true;
}

void WaveTable::eval(double X, double Y, double* i0, double* i1) const {
    // near the origin the smooth parts still carry directional (X/Y-angle)
    // structure the first bilinear cells cannot represent (errors up to
    // ~0.3 absolute at rho ~ 0.02, which bias every distant panel pair at
    // low frequency); evaluate exactly there instead.  Only nu*R, nu*|z+z'|
    // both small lands here, so the extra quadrature cost is confined to
    // the cheap low-frequency end of the sweep.
    double rho0 = sqrt(X * X + Y * Y);
    if (rho0 < 0.25 && rho0 > 1e-13) {
        analytic_I(X, Y, i0, i1);
        return;
    }
    // beyond XMAX use the far-field asymptotics; beyond Y range the
    // integrand is dead (e^{uY} kills everything except the 1/r1-type part)
    if (X >= XMAX - 1e-9) {
        // I0 -> -pi e^Y Y0(X), I1 -> -pi e^Y Y1(X) (pole-dominated far field)
        *i0 = -PI * exp(Y) * y0(X);
        *i1 = -PI * exp(Y) * y1(X);
        return;
    }
    double s = log(1.0 - Y);
    if (s >= SMAX - 1e-12) {
        // very deep: leading term of the 1/k expansion
        double rr = sqrt(X * X + Y * Y);
        *i0 = -1.0 / rr;
        *i1 = X > 1e-9 ? -(1.0 / X) * (1.0 - (-Y) / rr) : 0.0;
        return;
    }
    double fx = X / (XMAX / (NX - 1));
    int ix = (int)fx; double tx = fx - ix;
    double fs = s / (SMAX / (NS - 1));
    int is = (int)fs; double ts = fs - is;
    if (ix >= NX - 1) { ix = NX - 2; tx = 1.0; }
    if (is >= NS - 1) { is = NS - 2; ts = 1.0; }
    auto lerp = [&](const std::vector<double>& T) {
        double a = T[(size_t)ix * NS + is], b = T[(size_t)(ix + 1) * NS + is];
        double c = T[(size_t)ix * NS + is + 1], d = T[(size_t)(ix + 1) * NS + is + 1];
        return (1 - tx) * ((1 - ts) * a + ts * c) + tx * ((1 - ts) * b + ts * d);
    };
    *i0 = lerp(I0) + sing_I0(X, Y);
    *i1 = lerp(I1) + sing_I1(X, Y);
}

static WaveTable g_table;

// -------------------------------------------------------- finite depth
//
// Finite-depth free-surface Green function (e^{i w t}, depth h):
//   G = 1/r + 1/r2 + Gw,   r2 = seabed image of Q (vertical z+zeta+2h),
//   Gw = 2 PV Int_0^inf F(mu) sum_i e^{-mu d_i} J0(mu R) dmu
//        - 2 pi i A0 sum_i e^{-k0 d_i} J0(k0 R),
//   F(mu) = (mu+nu) / (2[(mu-nu) - (mu+nu) e^{-2 mu h}]),   nu = w^2/g,
//   d1 = -(z+zeta), d2 = 2h-(z-zeta), d3 = 2h+(z-zeta), d4 = 4h+(z+zeta),
//   k0: positive root of k tanh(kh) = nu,  A0 = Res_{mu=k0} F.
// (Derived by expanding cosh mu(z+h) cosh mu(zeta+h) into four
// exponentials in Wehausen & Laitone eq. 13.19; cross-validated to 8
// digits against John's eigenfunction series and, in the kh -> inf limit,
// against the deep-water form above.)
//
// Evaluation strategy (Delhommeau-style, per frequency):
//   2F(mu) = 1 + 2A0/(mu-k0) + rho(mu),  rho smooth and decaying ->
//   per image i:  "1"    -> 1/sqrt(R^2+d_i^2)        (closed form)
//                 pole   -> 2 A0 I0(k0 R, -k0 d_i)   (deep-water PV table)
//                 rho    -> sum_j a_j/sqrt(R^2+(d_i+lam_j)^2)
// with rho(mu) ~= sum_j a_j e^{-lam_j mu} least-squares fit on a fixed
// geometric lambda grid (46 terms; fit residual ~1e-6, overall Green
// function error vs the eigenfunction series ~1e-4 relative for k0h <= 6).
// For k0 h > 10 the finite-depth corrections are O(e^{-2 k0 h}) < 1e-8 and
// the deep-water path is used instead.
//
// The i=1 "1" term is exactly the free-surface image 1/r1, which the
// assembly integrates over the panel (Rankine) rather than at centroids;
// eval() therefore EXCLUDES it, and includes 1/r2 (smooth for floating
// bodies: vertical distance >= 2(h - draft)).

struct FDGreen {
    double h = 0, nu = 0, k0 = 0, A0 = 0;
    bool active = false;
    static constexpr int NL = 46;
    double lam[NL], a[NL];

    static double dispersion(double nu, double h) {
        double k = nu * h < 1.0 ? sqrt(nu / h) : nu;
        for (int it = 0; it < 100; it++) {
            double t = tanh(k * h);
            double c = cosh(k * h);
            double f = k * t - nu;
            double df = t + k * h / (c * c);
            double dk = f / df;
            k -= dk;
            if (fabs(dk) < 1e-15 * (k + 1e-300)) break;
        }
        return k;
    }

    void setup(double nu_, double h_) {
        nu = nu_; h = h_;
        active = false;
        if (h <= 0 || nu <= 0) return;
        k0 = dispersion(nu, h);
        if (k0 * h >= 10.0) return;                   // deep water regime
        active = true;
        double e2 = exp(-2.0 * k0 * h);
        A0 = (k0 + nu) / (2.0 * (1.0 - e2 + 2.0 * h * (k0 + nu) * e2));
        // sample rho(mu) = 2F(mu) - 1 - 2A0/(mu-k0) on [0, mumax]
        const int NS = 1200;
        double mumax = 20.0 * (k0 > 1.0 / h ? k0 : 1.0 / h);
        std::vector<double> mu(NS), y(NS);
        for (int i = 0; i < NS; i++) {
            double t = (double)i / (NS - 1);
            double m = mumax * t * t;                 // denser near 0
            double ref = k0 > 1.0 ? k0 : 1.0;
            if (fabs(m - k0) < 1e-9 * ref) m += 1e-6 * ref;
            mu[i] = m;
            double F = (m + nu) /
                       (2.0 * ((m - nu) - (m + nu) * exp(-2.0 * m * h)));
            y[i] = 2.0 * F - 1.0 - 2.0 * A0 / (m - k0);
        }
        // geometric lambda grid spanning the decay scales of rho
        double lmin = (h < 1.0 / k0 ? h : 1.0 / k0) / 50.0;
        double lmax = 50.0 / (mumax / 20.0);
        for (int j = 0; j < NL; j++)
            lam[j] = lmin * pow(lmax / lmin, (double)j / (NL - 1));
        // least squares via scaled normal equations + tiny ridge
        std::vector<double> B((size_t)NS * NL);
        double coln[NL];
        for (int j = 0; j < NL; j++) {
            double s2 = 0.0;
            for (int i = 0; i < NS; i++) {
                double v = exp(-mu[i] * lam[j]);
                B[(size_t)i * NL + j] = v;
                s2 += v * v;
            }
            coln[j] = sqrt(s2);
        }
        double M[NL][NL], rhs[NL];
        for (int j = 0; j < NL; j++) {
            rhs[j] = 0.0;
            for (int i = 0; i < NS; i++)
                rhs[j] += B[(size_t)i * NL + j] / coln[j] * y[i];
            for (int l = 0; l < NL; l++) {
                double s = 0.0;
                for (int i = 0; i < NS; i++)
                    s += B[(size_t)i * NL + j] * B[(size_t)i * NL + l];
                M[j][l] = s / (coln[j] * coln[l]);
            }
            M[j][j] += 1e-10;
        }
        // Gaussian elimination with partial pivoting (NL x NL)
        int piv[NL];
        for (int j = 0; j < NL; j++) piv[j] = j;
        for (int c = 0; c < NL; c++) {
            int p = c; double best = fabs(M[c][c]);
            for (int i = c + 1; i < NL; i++)
                if (fabs(M[i][c]) > best) { best = fabs(M[i][c]); p = i; }
            if (p != c) {
                for (int j = 0; j < NL; j++) std::swap(M[c][j], M[p][j]);
                std::swap(rhs[c], rhs[p]);
            }
            for (int i = c + 1; i < NL; i++) {
                double f = M[i][c] / M[c][c];
                for (int j = c; j < NL; j++) M[i][j] -= f * M[c][j];
                rhs[i] -= f * rhs[c];
            }
        }
        for (int i = NL - 1; i >= 0; i--) {
            double s = rhs[i];
            for (int j = i + 1; j < NL; j++) s -= M[i][j] * a[j];
            a[i] = s / M[i][i];
        }
        for (int j = 0; j < NL; j++) a[j] /= coln[j];
    }

    // Wave part at field point P=(R horizontal, zP) vs source zQ,
    // EXCLUDING 1/r and the free-surface image 1/r1, INCLUDING the seabed
    // image 1/r2.  Returns G and its derivatives w.r.t. R and zP.
    void eval(double R, double zP, double zQ,
              cdouble* G, cdouble* dG_dR, cdouble* dG_dz) const {
        double d[4] = { -(zP + zQ), 2.0 * h - (zP - zQ),
                        2.0 * h + (zP - zQ), 4.0 * h + (zP + zQ) };
        static const double sgn[4] = { -1.0, -1.0, 1.0, 1.0 };
        double gre = 0.0, gre_R = 0.0, gre_z = 0.0;
        double gim = 0.0, gim_R = 0.0, gim_z = 0.0;
        double X = k0 * R;
        double J0 = j0(X), J1 = j1(X);
        for (int i = 0; i < 4; i++) {
            double di = d[i], si = sgn[i];
            // "1" part (skip i=0: that is 1/r1, Rankine-integrated outside)
            if (i > 0) {
                double rr2 = R * R + di * di;
                double rr = sqrt(rr2);
                double t3 = 1.0 / (rr2 * rr);
                gre += 1.0 / rr;
                gre_R += -R * t3;
                gre_z += -di * t3 * si;
            }
            // pole part: 2 A0 I0(k0 R, -k0 d_i)
            {
                double Y = -k0 * di;
                double i0, i1;
                g_table.eval(X, Y, &i0, &i1);
                double rxy = sqrt(X * X + Y * Y);
                if (rxy < 1e-12) rxy = 1e-12;
                double C1 = X > 1e-12 ? (1.0 / X) * (1.0 - (-Y) / rxy) : 0.0;
                gre += 2.0 * A0 * i0;
                gre_R += 2.0 * A0 * k0 * (-(C1 + i1));
                gre_z += 2.0 * A0 * (-k0 * si) * (1.0 / rxy + i0);
            }
            // exp-fit part
            for (int j = 0; j < NL; j++) {
                double c = di + lam[j];
                double rr2 = R * R + c * c;
                double rr = sqrt(rr2);
                double t3 = a[j] / (rr2 * rr);
                gre += a[j] / rr;
                gre_R += -R * t3;
                gre_z += -c * t3 * si;
            }
            // imaginary (radiated-wave) part
            double e = exp(-k0 * di);
            gim += -2.0 * PI * A0 * e * J0;
            gim_R += 2.0 * PI * A0 * k0 * e * J1;
            gim_z += 2.0 * PI * A0 * k0 * si * e * J0;
        }
        // seabed image 1/r2 (vertical zP + zQ + 2h; d(v2)/dzP = +1)
        {
            double v2 = zP + zQ + 2.0 * h;
            double rr2 = R * R + v2 * v2;
            double rr = sqrt(rr2);
            double t3 = 1.0 / (rr2 * rr);
            gre += 1.0 / rr;
            gre_R += -R * t3;
            gre_z += -v2 * t3;
        }
        *G = cdouble(gre, gim);
        *dG_dR = cdouble(gre_R, gim_R);
        *dG_dz = cdouble(gre_z, gim_z);
    }
};

// ------------------------------------------------------------- geometry

struct Panel {
    double v[4][3];
    double c[3];        // centroid
    double n[3];        // unit normal (outward from body, into fluid)
    double area;
    double diag;
};

static void panel_setup(Panel& p) {
    double d1[3], d2[3];
    for (int i = 0; i < 3; i++) {
        d1[i] = p.v[2][i] - p.v[0][i];
        d2[i] = p.v[3][i] - p.v[1][i];
        p.c[i] = 0.25 * (p.v[0][i] + p.v[1][i] + p.v[2][i] + p.v[3][i]);
    }
    double nx = 0.5 * (d1[1] * d2[2] - d1[2] * d2[1]);
    double ny = 0.5 * (d1[2] * d2[0] - d1[0] * d2[2]);
    double nz = 0.5 * (d1[0] * d2[1] - d1[1] * d2[0]);
    p.area = sqrt(nx * nx + ny * ny + nz * nz);
    double inv = p.area > 1e-14 ? 1.0 / p.area : 0.0;
    p.n[0] = nx * inv; p.n[1] = ny * inv; p.n[2] = nz * inv;
    double l1 = sqrt(d1[0]*d1[0] + d1[1]*d1[1] + d1[2]*d1[2]);
    double l2 = sqrt(d2[0]*d2[0] + d2[1]*d2[1] + d2[2]*d2[2]);
    p.diag = l1 > l2 ? l1 : l2;
}

// exact Int 1/r dS over the flat polygon, field point at its centroid
// (in-plane): sum over edges of d*ln((ra+rb+s)/(ra+rb-s))
static double self_rankine_potential(const Panel& p) {
    double tot = 0.0;
    for (int e = 0; e < 4; e++) {
        const double* a = p.v[e];
        const double* b = p.v[(e + 1) % 4];
        double ab[3] = {b[0]-a[0], b[1]-a[1], b[2]-a[2]};
        double s = sqrt(ab[0]*ab[0] + ab[1]*ab[1] + ab[2]*ab[2]);
        if (s < 1e-12) continue;                      // degenerate (triangle)
        double ca[3] = {a[0]-p.c[0], a[1]-p.c[1], a[2]-p.c[2]};
        double cb[3] = {b[0]-p.c[0], b[1]-p.c[1], b[2]-p.c[2]};
        double ra = sqrt(ca[0]*ca[0] + ca[1]*ca[1] + ca[2]*ca[2]);
        double rb = sqrt(cb[0]*cb[0] + cb[1]*cb[1] + cb[2]*cb[2]);
        // signed perpendicular distance from centroid to edge (in plane):
        // d = |(a-c) x (b-a)| / s  with sign via normal -- area convention
        double cr[3] = {ca[1]*ab[2]-ca[2]*ab[1], ca[2]*ab[0]-ca[0]*ab[2], ca[0]*ab[1]-ca[1]*ab[0]};
        double dsign = cr[0]*p.n[0] + cr[1]*p.n[1] + cr[2]*p.n[2];
        double d = dsign / s;
        double num = ra + rb + s, den = ra + rb - s;
        if (den < 1e-14) den = 1e-14;
        tot += d * log(num / den);
    }
    return fabs(tot);
}

// Rankine 1/r potential+gradient of panel q integrated at point P, with
// ns x ns Gauss subdivision (bilinear quad map)
static void rankine_integral(const Panel& q, const double* P, int ns,
                             double* pot, double grad[3]) {
    *pot = 0.0; grad[0] = grad[1] = grad[2] = 0.0;
    for (int iu = 0; iu < ns; iu++) {
        for (int iv = 0; iv < ns; iv++) {
            double u = (iu + 0.5) / ns, v = (iv + 0.5) / ns;
            // bilinear interior point and Jacobian-weighted area element
            double pt[3];
            for (int d = 0; d < 3; d++) {
                pt[d] = (1-u)*(1-v)*q.v[0][d] + u*(1-v)*q.v[1][d]
                      + u*v*q.v[2][d] + (1-u)*v*q.v[3][d];
            }
            double dA = q.area / (ns * ns);          // flat-panel approx
            double dx = P[0]-pt[0], dy = P[1]-pt[1], dz = P[2]-pt[2];
            double r2 = dx*dx + dy*dy + dz*dz;
            double r = sqrt(r2);
            if (r < 1e-12) continue;
            double ir = 1.0 / r, ir3 = ir / r2;
            *pot += dA * ir;
            grad[0] -= dA * dx * ir3;                // d(1/r)/dPx = -dx/r^3
            grad[1] -= dA * dy * ir3;
            grad[2] -= dA * dz * ir3;
        }
    }
}

// --------------------------------------------------------------- solver

struct Influence {
    // S phi and D normal-derivative matrices (complex)
    std::vector<cdouble> S, D;
};

static void wave_part(double k, const double* P, const double* Q,
                      cdouble* G, cdouble gradP[3]) {
    // image of Q above the surface enters via v = z_P + z_Q
    double dx = P[0]-Q[0], dy = P[1]-Q[1];
    double R = sqrt(dx*dx + dy*dy);
    double v = P[2] + Q[2];                           // <= 0
    double X = k * R, Y = k * v;
    double i0, i1;
    g_table.eval(X, Y, &i0, &i1);
    double eY = exp(Y);
    double J0 = j0(X), J1v = j1(X);
    *G = 2.0 * k * cdouble(i0, -PI * eY * J0);
    // d/dv = 2k [ k/sqrt(R^2+v^2)_dim... ]: dI0/dv = k(1/sqrt(X^2+Y^2)) ...
    double rr = sqrt(R*R + v*v);
    if (rr < 1e-12) rr = 1e-12;
    double dI0_dv = 1.0 / rr + k * i0;                // identity: no new integral
    double dIm_dv = -PI * k * eY * J0;                // d(e^Y J0)/dv * -pi ... times k
    cdouble dG_dv = 2.0 * k * cdouble(dI0_dv, dIm_dv);
    // d/dR: dI0/dR = -k [ C1 + I1 ],  C1 = (1/X)(1 - (-Y)/sqrt(X^2+Y^2))
    double C1 = 0.0;
    if (R > 1e-12) C1 = (1.0 / R) * (1.0 - (-v) / rr);
    double dI0_dR = -(C1 + k * i1);
    double dIm_dR = PI * k * eY * J1v;                // d(-pi e^Y J0(kR))/dR
    cdouble dG_dR = 2.0 * k * cdouble(dI0_dR, dIm_dR);
    double ux = R > 1e-12 ? dx / R : 0.0;
    double uy = R > 1e-12 ? dy / R : 0.0;
    gradP[0] = dG_dR * ux;
    gradP[1] = dG_dR * uy;
    gradP[2] = dG_dv;
}

static void assemble(const std::vector<Panel>& pan, double k,
                     const FDGreen* fd, Influence& inf) {
    int n = (int)pan.size();
    inf.S.assign((size_t)n * n, 0.0);
    inf.D.assign((size_t)n * n, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < n; i++) {
        const double* P = pan[i].c;
        for (int j = 0; j < n; j++) {
            const Panel& q = pan[j];
            double dx = P[0]-q.c[0], dy = P[1]-q.c[1], dz = P[2]-q.c[2];
            double dist = sqrt(dx*dx + dy*dy + dz*dz);
            double pot = 0.0, grad[3] = {0, 0, 0};
            if (i == j) {
                pot = self_rankine_potential(q);
                // PV of flat-panel 1/r normal derivative at centroid = 0
            } else {
                double rel = dist / q.diag;
                int ns = rel < 1.0 ? 12 : rel < 2.0 ? 6 : rel < 6.0 ? 3 : 1;
                rankine_integral(q, P, ns, &pot, grad);
            }
            // image (1/r1): field point vs image panel (z -> -z of Q).
            // panels at the waterline nearly coincide with their own image,
            // so the subdivision must go much finer than for body pairs
            double potI, gradI[3] = {0, 0, 0};
            Panel qi = q;
            for (int vv = 0; vv < 4; vv++) qi.v[vv][2] = -q.v[vv][2];
            qi.c[2] = -q.c[2];
            {
                double dzI = P[2] - qi.c[2];
                double distI = sqrt(dx*dx + dy*dy + dzI*dzI);
                if (i == j && distI < 1e-9 * q.diag) {
                    // lid panel AT z=0: the image coincides with the panel
                    // itself -- exact self potential, PV gradient 0
                    potI = self_rankine_potential(qi);
                } else {
                    double rel = distI / q.diag;
                    int ns = rel < 0.5 ? 24 : rel < 1.0 ? 12 : rel < 2.0 ? 6
                           : rel < 6.0 ? 3 : 1;
                    rankine_integral(qi, P, ns, &potI, gradI);
                }
            }
            // wave part at centroids (smooth); finite depth adds the
            // seabed image and evanescent-mode corrections.  A lid panel's
            // self term sits exactly at the R=0, z=z'=0 log singularity of
            // the wave kernel: use the panel's log-average radius as the
            // effective evaluation point (panel-mean of the ln term)
            cdouble Gw, gw[3];
            double R_eff = sqrt(dx * dx + dy * dy);
            if (i == j && R_eff < 1e-12 && fabs(P[2]) < 1e-9 * q.diag) {
                R_eff = 0.4 * sqrt(q.area);
            }
            if (fd && fd->active) {
                double R = R_eff;
                cdouble G, dGdR, dGdz;
                fd->eval(R, P[2], q.c[2], &G, &dGdR, &dGdz);
                double ux = R > 1e-12 ? dx / R : 0.0;
                double uy = R > 1e-12 ? dy / R : 0.0;
                Gw = G;
                gw[0] = dGdR * ux;
                gw[1] = dGdR * uy;
                gw[2] = dGdz;
            } else {
                double Pe[3] = { P[0], P[1], P[2] };
                if (i == j && R_eff > 0 && sqrt(dx * dx + dy * dy) < 1e-12) {
                    Pe[0] = q.c[0] + R_eff;   // lid self: log-average offset
                }
                wave_part(k, Pe, q.c, &Gw, gw);
            }
            cdouble S = pot + potI + Gw * q.area;
            cdouble Dn = (grad[0] + gradI[0] + gw[0] * q.area) * pan[i].n[0]
                       + (grad[1] + gradI[1] + gw[1] * q.area) * pan[i].n[1]
                       + (grad[2] + gradI[2] + gw[2] * q.area) * pan[i].n[2];
            // fold the Gauss-subdivided gradients' area in: rankine_integral
            // already integrates dS, wave part multiplies area explicitly
            inf.S[(size_t)i * n + j] = S;
            inf.D[(size_t)i * n + j] = Dn;
        }
    }
}

// complex LU with partial pivoting, in place; b: n x m RHS
static int lu_solve(std::vector<cdouble>& A, std::vector<cdouble>& B, int n, int m) {
    std::vector<int> piv(n);
    for (int kcol = 0; kcol < n; kcol++) {
        int p = kcol; double best = std::abs(A[(size_t)kcol * n + kcol]);
        for (int i = kcol + 1; i < n; i++) {
            double v = std::abs(A[(size_t)i * n + kcol]);
            if (v > best) { best = v; p = i; }
        }
        if (best < 1e-30) return -1;
        if (p != kcol) {
            for (int j = 0; j < n; j++) std::swap(A[(size_t)kcol*n+j], A[(size_t)p*n+j]);
            for (int j = 0; j < m; j++) std::swap(B[(size_t)kcol*m+j], B[(size_t)p*m+j]);
        }
        cdouble inv = 1.0 / A[(size_t)kcol * n + kcol];
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int i = kcol + 1; i < n; i++) {
            cdouble f = A[(size_t)i * n + kcol] * inv;
            A[(size_t)i * n + kcol] = f;
            for (int j = kcol + 1; j < n; j++)
                A[(size_t)i * n + j] -= f * A[(size_t)kcol * n + j];
            for (int j = 0; j < m; j++)
                B[(size_t)i * m + j] -= f * B[(size_t)kcol * m + j];
        }
    }
    // back substitution
    for (int i = n - 1; i >= 0; i--) {
        for (int j = 0; j < m; j++) {
            cdouble s = B[(size_t)i * m + j];
            for (int kk = i + 1; kk < n; kk++)
                s -= A[(size_t)i * n + kk] * B[(size_t)kk * m + j];
            B[(size_t)i * m + j] = s / A[(size_t)i * n + i];
        }
    }
    return 0;
}

extern "C" {

// where the wave-integral table is cached on disk (read if whole, else
// built and published); call before the first solve or probe
void bem_set_table_path(const char* path) {
    snprintf(g_table_path, sizeof(g_table_path), "%s", path ? path : "");
}

// panels: np x 4 x 3 (row-major); w: nw angular frequencies; depth <= 0
// means infinite depth (deep water).  Outputs (row-major): A, Bo:
// nw x 6 x 6; Fre, Fim: nw x 6.  Returns 0 on success.
static int solve_core(const double* panels, int np,
                      const double* w, int nw, double depth,
                      double rho, double g,
                      const double* betas, int nb,
                      double* A, double* Bo, double* Fre, double* Fim,
                      double* Fhre, double* Fhim,
                      int nthreads, int nlid) {
    // nlid > 0: the LAST nlid panels are an interior waterplane lid.  The
    // extended boundary integral equation forces the interior extension of
    // the potential to vanish on the lid (sigma rows: S sigma = phi target,
    // no jump term for the continuous single layer), which removes the
    // irregular frequencies of the plain source formulation -- the
    // capability behind the reference's HAMS `irr` flag
    // (hams/pyhams.py:200,284), which its missing Fortran binary never
    // actually exercised.
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    g_table.build();
    std::vector<Panel> pan(np);
    for (int i = 0; i < np; i++) {
        for (int vv = 0; vv < 4; vv++)
            for (int d = 0; d < 3; d++)
                pan[i].v[vv][d] = panels[((size_t)i * 4 + vv) * 3 + d];
        panel_setup(pan[i]);
    }
    int n = np;
    int nh = np - nlid;                           // hull panels (wetted)
    for (int iw = 0; iw < nw; iw++) {
        double om = w[iw];
        double k = om * om / g;                       // nu (deep wavenumber)
        FDGreen fd;
        fd.setup(k, depth);
        // incident wave number and stable depth-profile factors:
        //   Zr = cosh(kw(z+h))/cosh(kw h),  Zs = sinh(kw(z+h))/cosh(kw h)
        double kw = fd.active ? fd.k0 : k;
        auto Zr = [&](double z) {
            if (!fd.active) return exp(kw * z);
            double e = exp(-2.0 * kw * (z + depth));
            return exp(kw * z) * (1.0 + e) / (1.0 + exp(-2.0 * kw * depth));
        };
        auto Zs = [&](double z) {
            if (!fd.active) return exp(kw * z);
            double e = exp(-2.0 * kw * (z + depth));
            return exp(kw * z) * (1.0 - e) / (1.0 + exp(-2.0 * kw * depth));
        };
        Influence inf;
        assemble(pan, k, fd.active ? &fd : nullptr, inf);
        // system: (-2 pi I + D) sigma = rhs, 6 + nb RHS (6 radiation + one
        // diffraction column per heading -- the LU is factored once and
        // every extra heading is just another back-substitution)
        // -- exterior limit with the collocation normal pointing INTO the
        // fluid gives the jump  d(phi)/dn -> -2 pi sigma + PV D sigma
        // (verified against the sphere single-layer harmonics: S Y_n =
        // 4 pi a/(2n+1) Y_n, D Y_n = -2 pi/(2n+1) Y_n).
        std::vector<cdouble> M = inf.D;
        for (int i = 0; i < n; i++) M[(size_t)i * n + i] += -2.0 * PI;
        // lid rows: Dirichlet condition on the interior free surface
        for (int i = nh; i < n; i++)
            for (int j = 0; j < n; j++)
                M[(size_t)i * n + j] = inf.S[(size_t)i * n + j];
        int m = 6 + nb;
        std::vector<cdouble> rhs((size_t)n * m);
        std::vector<cdouble> dphiI_dn((size_t)n * nb);   // saved for Haskind
        for (int i = 0; i < n; i++) {
            const Panel& p = pan[i];
            double rx = p.c[0], ry = p.c[1], rz = p.c[2];
            double nvec[6] = {
                p.n[0], p.n[1], p.n[2],
                ry * p.n[2] - rz * p.n[1],
                rz * p.n[0] - rx * p.n[2],
                rx * p.n[1] - ry * p.n[0],
            };
            bool lid = i >= nh;
            for (int kk = 0; kk < 6; kk++)
                rhs[(size_t)i * m + kk] = lid ? 0.0 : nvec[kk];
            for (int ib = 0; ib < nb; ib++) {
                double cb = cos(betas[ib]), sb = sin(betas[ib]);
                // incident wave (unit amplitude, e^{iwt}):
                //   phi_I = (g/om) i Zr(z) e^{-i kw (x cos b + y sin b)}
                // deep water: Zr = Zs = e^{kw z}; finite depth: cosh/sinh
                // profile over the water column (kw = k0)
                cdouble phase = std::exp(cdouble(0.0, -kw * (rx * cb + ry * sb)));
                cdouble ph = cdouble(0.0, g / om) * Zr(rz) * phase;
                // grad phi_I
                cdouble ddx = ph * cdouble(0.0, -kw * cb);
                cdouble ddy = ph * cdouble(0.0, -kw * sb);
                cdouble ddz = cdouble(0.0, g / om) * kw * Zs(rz) * phase;
                cdouble dn = ddx * p.n[0] + ddy * p.n[1] + ddz * p.n[2];
                dphiI_dn[(size_t)i * nb + ib] = dn;
                // hull: Neumann  dphi_S/dn = -dphi_I/dn
                // lid:  Dirichlet phi_S = -phi_I  (zero interior total)
                rhs[(size_t)i * m + 6 + ib] = lid ? -ph : -dn;
            }
        }
        if (lu_solve(M, rhs, n, m) != 0) return -1;
        // panel potentials phi = S sigma for ALL columns at once (one n^2 m
        // pass instead of re-accumulating per coefficient pair)
        std::vector<cdouble> phi((size_t)n * m, cdouble(0.0, 0.0));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int i = 0; i < n; i++)
            for (int q = 0; q < n; q++) {
                cdouble s = inf.S[(size_t)i * n + q];
                for (int kk = 0; kk < m; kk++)
                    phi[(size_t)i * m + kk] += s * rhs[(size_t)q * m + kk];
            }
        // radiation coefficients: A - i B/om = rho Int phi_k n_j dS
        for (int kk = 0; kk < 6; kk++) {
            for (int j = 0; j < 6; j++) {
                cdouble acc = 0.0;
                for (int i = 0; i < nh; i++) {    // wetted hull only
                    const Panel& p = pan[i];
                    double nvec[6] = {
                        p.n[0], p.n[1], p.n[2],
                        p.c[1] * p.n[2] - p.c[2] * p.n[1],
                        p.c[2] * p.n[0] - p.c[0] * p.n[2],
                        p.c[0] * p.n[1] - p.c[1] * p.n[0],
                    };
                    acc += phi[(size_t)i * m + kk] * nvec[j] * p.area;
                }
                // from -i w A - B = i w rho Int phi n dS (unit velocity):
                //   A = -rho Re I,  B = +w rho Im I
                cdouble val = rho * acc;
                A[((size_t)iw * 6 + j) * 6 + kk] = -val.real();
                Bo[((size_t)iw * 6 + j) * 6 + kk] = val.imag() * om;
            }
        }
        // excitation per heading:
        //   direct:  X_j = i om rho Int (phi_I + phi_S) n_j dS
        //   Haskind: X_j = i om rho Int (phi_I n_j - phi_j dphi_I/dn) dS
        // (Green's identity on the radiation/scattering pair turns
        //  Int phi_S n_j dS into -Int phi_j dphi_I/dn dS; agreement of the
        //  two is a solver self-consistency check in amplitude AND phase)
        for (int ib = 0; ib < nb; ib++) {
            double cb = cos(betas[ib]), sb = sin(betas[ib]);
            for (int j = 0; j < 6; j++) {
                cdouble acc = 0.0, acch = 0.0;
                for (int i = 0; i < nh; i++) {    // wetted hull only
                    const Panel& p = pan[i];
                    cdouble phiS = phi[(size_t)i * m + 6 + ib];
                    cdouble phiI = cdouble(0.0, g / om) * Zr(p.c[2])
                                 * std::exp(cdouble(0.0, -kw * (p.c[0] * cb + p.c[1] * sb)));
                    double nvec[6] = {
                        p.n[0], p.n[1], p.n[2],
                        p.c[1] * p.n[2] - p.c[2] * p.n[1],
                        p.c[2] * p.n[0] - p.c[0] * p.n[2],
                        p.c[0] * p.n[1] - p.c[1] * p.n[0],
                    };
                    acc += (phiI + phiS) * nvec[j] * p.area;
                    acch += (phiI * nvec[j]
                             - phi[(size_t)i * m + j] * dphiI_dn[(size_t)i * nb + ib])
                            * p.area;
                }
                cdouble X = cdouble(0.0, om) * rho * acc;
                Fre[((size_t)iw * nb + ib) * 6 + j] = X.real();
                Fim[((size_t)iw * nb + ib) * 6 + j] = X.imag();
                if (Fhre && Fhim) {
                    cdouble Xh = cdouble(0.0, om) * rho * acch;
                    Fhre[((size_t)iw * nb + ib) * 6 + j] = Xh.real();
                    Fhim[((size_t)iw * nb + ib) * 6 + j] = Xh.imag();
                }
            }
        }
    }
    return 0;
}

int bem_solve_mh(const double* panels, int np,
                 const double* w, int nw, double depth,
                 double rho, double g,
                 const double* betas, int nb,
                 double* A, double* Bo, double* Fre, double* Fim,
                 double* Fhre, double* Fhim,
                 int nthreads, int nlid) {
    return solve_core(panels, np, w, nw, depth, rho, g, betas, nb,
                      A, Bo, Fre, Fim, Fhre, Fhim, nthreads, nlid);
}

int bem_solve(const double* panels, int np,
              const double* w, int nw, double depth,
              double rho, double g, double beta,
              double* A, double* Bo, double* Fre, double* Fim,
              int nthreads) {
    return solve_core(panels, np, w, nw, depth, rho, g, &beta, 1,
                      A, Bo, Fre, Fim, nullptr, nullptr, nthreads, 0);
}

// backward-compatible deep-water entry
int bem_solve_deep(const double* panels, int np,
                   const double* w, int nw,
                   double rho, double g, double beta,
                   double* A, double* Bo, double* Fre, double* Fim,
                   int nthreads) {
    return bem_solve(panels, np, w, nw, -1.0, rho, g, beta,
                     A, Bo, Fre, Fim, nthreads);
}

// finite-depth Green function probe for unit tests: returns the FULL
// G = 1/r + 1/r1 + (wave part incl. 1/r2) and its gradient w.r.t. the
// field point (dR, dz).  out = [Gre, Gim, dGdR_re, dGdR_im, dGdz_re,
// dGdz_im].  Falls back to the deep-water form when k0*depth >= 10.
void bem_green_fd(double nu, double depth, double R, double zP, double zQ,
                  double* out) {
    g_table.build();
    FDGreen fd;
    fd.setup(nu, depth);
    cdouble G, dGdR, dGdz;
    if (fd.active) {
        fd.eval(R, zP, zQ, &G, &dGdR, &dGdz);
        // add the direct and free-surface-image Rankine terms
        double dz_d = zP - zQ, dz_i = zP + zQ;
        double r2d = R * R + dz_d * dz_d, r2i = R * R + dz_i * dz_i;
        double rd = sqrt(r2d), ri = sqrt(r2i);
        G += 1.0 / rd + 1.0 / ri;
        dGdR += -R / (r2d * rd) - R / (r2i * ri);
        dGdz += -dz_d / (r2d * rd) - dz_i / (r2i * ri);
    } else {
        double P[3] = { R, 0.0, zP }, Q[3] = { 0.0, 0.0, zQ };
        cdouble gw[3];
        wave_part(nu, P, Q, &G, gw);
        dGdR = gw[0];
        dGdz = gw[2];
        double dz_d = zP - zQ, dz_i = zP + zQ;
        double r2d = R * R + dz_d * dz_d, r2i = R * R + dz_i * dz_i;
        double rd = sqrt(r2d), ri = sqrt(r2i);
        G += 1.0 / rd + 1.0 / ri;
        dGdR += -R / (r2d * rd) - R / (r2i * ri);
        dGdz += -dz_d / (r2d * rd) - dz_i / (r2i * ri);
    }
    out[0] = G.real(); out[1] = G.imag();
    out[2] = dGdR.real(); out[3] = dGdR.imag();
    out[4] = dGdz.real(); out[5] = dGdz.imag();
}

// dispersion probe: k0 with k0 tanh(k0 h) = nu
double bem_dispersion(double nu, double depth) {
    return FDGreen::dispersion(nu, depth);
}

// probe Phi(zeta) for unit tests
void bem_phi_probe(double re, double im, double* pre, double* pim) {
    cdouble p = phi_pv(cdouble(re, im));
    *pre = p.real();
    *pim = p.imag();
}

// quick probe of the wave-integral table for unit tests
void bem_wave_integral(double X, double Y, double* i0, double* i1) {
    g_table.build();
    g_table.eval(X, Y, i0, i1);
}

void bem_wave_integral_direct(double X, double Y, double* i0, double* i1) {
    *i0 = WaveTable::direct_I(X, Y, 0);
    *i1 = WaveTable::direct_I(X, Y, 1);
}

}  // extern "C"
