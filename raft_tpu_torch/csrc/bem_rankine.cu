// Kernel K3: Rankine direct + free-surface-image panel integrals of the
// on-device BEM, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/core/pallas_bem.py::_rankine_kernel
// (reached through rankine_assembly).  For every (field panel i, source
// panel j) pair it returns
//   R_pot[i, j] = pot_d + pot_i
//   R_dn[i, j]  = (grad_d + grad_i) . n_i
// where the direct (1/r) and image (1/r1) integrals over panel j are taken
// by ns x ns midpoint subdivision at the centroid of panel i.  The level
// (ns in 1/3/6/12 direct, 1/3/6/12/24 image) is chosen per pair from
// distance over panel diagonal; the direct self term is the exact
// flat-panel potential (computed outside, passed as spot), doubled on the
// diagonal of a lid panel at z = 0, whose image is itself.  Masked-out
// (padding) source columns are zero.
//
// Design.  The TPU kernel evaluates all 766 subdivision points for every
// pair and masks out all but the pair's level (956 contributions a pair).
// The masked terms are exact zeros, so here one thread per pair loops only
// over the points of its own direct level and its own image level: on the
// shipped meshes about 5 to 7 contributions a pair instead of 956.  The
// points keep their order within a level, and levels are visited in
// increasing order with the direct contribution of a point before its
// image one, so the sums associate exactly as in the plain version
// (raft_tpu_torch/hydro/torch_bem.py::rankine_plain).  Row and column ids
// are global (blockIdx * blockDim + threadIdx), so the diagonal is i == j.
// j is the fastest thread index: the stores of a warp are contiguous.
//
// Bound.  Operations: per pair the two level selections, per point its
// position, per contribution about 22 floating-point operations; with the
// few contributions a pair needs, the outputs (2 n^2 values) are written
// in about the same time as the arithmetic at n = 1024 in f64.  Later work
// (not done here): stage the source side of a tile in shared memory,
// schedule pairs by level so a warp runs one trip count, trim registers.
//
// Built with -fmad=false: every product and sum is rounded on its own, as
// PyTorch's elementwise kernels round them, so the f64 kernel agrees with
// its plain version to roundoff.
#include <cuda_runtime.h>

namespace {

// first point and point count of each level in the quadrature arrays
// (torch_bem.quad_points: levels 1, 3, 6, 12, then the image-only 24)
__constant__ int kLevelStart[5] = {0, 1, 10, 46, 190};
__constant__ int kLevelCount[5] = {1, 9, 36, 144, 576};

template <typename T>
__device__ __forceinline__ T safe_norm(T x, T y, T z) {
  return sqrt(x * x + y * y + z * z + T(1e-20));
}

template <typename T>
__device__ __forceinline__ int level_direct(T rel) {
  int out = rel < T(6) ? 1 : 0;
  if (rel < T(2)) out = 2;
  if (rel < T(1)) out = 3;
  return out;
}

template <typename T>
__device__ __forceinline__ int level_image(T rel) {
  int out = level_direct(rel);
  if (rel < T(0.5)) out = 4;
  return out;
}

// one point source of strength dA at p seen from the field point c_i
template <typename T>
__device__ __forceinline__ void contrib(T cx, T cy, T cz, T nx, T ny, T nz,
                                        T px, T py, T pz, T dA, T& pot, T& dn) {
  T dx = cx - px, dy = cy - py, dz = cz - pz;
  T r2 = dx * dx + dy * dy + dz * dz;
  if (r2 > T(1e-12)) {
    T ir = T(1) / sqrt(r2);
    T ir3 = ir / r2;
    pot = pot + dA * ir;
    T dsn = dx * nx + dy * ny + dz * nz;
    dn = dn + (-dA * ir3) * dsn;
  }
}

template <typename T>
__global__ void rankine_kernel(const T* __restrict__ pans, const T* __restrict__ c,
                               const T* __restrict__ nrm, const T* __restrict__ area,
                               const T* __restrict__ diag, const T* __restrict__ mask,
                               const T* __restrict__ lids, const T* __restrict__ spot,
                               const T* __restrict__ us, const T* __restrict__ vs,
                               const T* __restrict__ wf, int n,
                               T* __restrict__ R_pot, T* __restrict__ R_dn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= n) return;
  // field side
  const T cix = c[3 * i], ciy = c[3 * i + 1], ciz = c[3 * i + 2];
  const T nix = nrm[3 * i], niy = nrm[3 * i + 1], niz = nrm[3 * i + 2];
  // source side
  const T cjx = c[3 * j], cjy = c[3 * j + 1], cjz = c[3 * j + 2];
  const T* p = pans + 12 * j;
  const T area_j = area[j], diag_j = diag[j], lid_j = lids[j];

  const T dist = safe_norm(cix - cjx, ciy - cjy, ciz - cjz);
  const T distI = safe_norm(cix - cjx, ciy - cjy, ciz - (-cjz));
  const bool ok = diag_j > T(1e-9);
  const T diag_safe = ok ? diag_j : T(1);
  const T rel = ok ? dist / diag_safe : T(1e9);
  const T relI = ok ? distI / diag_safe : T(1e9);
  int sel_d = level_direct(rel);
  int sel_i = level_image(relI);
  if (i == j) {
    sel_d = -1;                        // exact self term instead
    if (lid_j > T(0.5)) sel_i = -1;    // lid at z = 0: its image is itself
  }

  T pot = T(0), dn = T(0);
  for (int lv = 0; lv < 5; ++lv) {
    const bool dd = lv == sel_d;
    const bool di = lv == sel_i;
    if (!dd && !di) continue;
    const int q0 = kLevelStart[lv], q1 = q0 + kLevelCount[lv];
    for (int q = q0; q < q1; ++q) {
      const T u = us[q], v = vs[q];
      const T c00 = (T(1) - u) * (T(1) - v), c10 = u * (T(1) - v);
      const T c11 = u * v, c01 = (T(1) - u) * v;
      const T px = c00 * p[0] + c10 * p[3] + c11 * p[6] + c01 * p[9];
      const T py = c00 * p[1] + c10 * p[4] + c11 * p[7] + c01 * p[10];
      const T pz = c00 * p[2] + c10 * p[5] + c11 * p[8] + c01 * p[11];
      const T dA = area_j * wf[q];
      if (dd) contrib(cix, ciy, ciz, nix, niy, niz, px, py, pz, dA, pot, dn);
      if (di) contrib(cix, ciy, ciz, nix, niy, niz, px, py, -pz, dA, pot, dn);
    }
  }
  if (i == j) pot = pot + spot[j] * (T(1) + lid_j);
  const T m = mask[j];
  const size_t o = static_cast<size_t>(i) * n + j;
  R_pot[o] = pot * m;
  R_dn[o] = dn * m;
}

template <typename T>
int launch(const void* pans, const void* c, const void* nrm, const void* area,
           const void* diag, const void* mask, const void* lids, const void* spot,
           const void* us, const void* vs, const void* wf, long long n,
           void* R_pot, void* R_dn, void* stream) {
  const dim3 block(64, 4);
  const dim3 grid(static_cast<unsigned>((n + 63) / 64), static_cast<unsigned>((n + 3) / 4));
  rankine_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pans), static_cast<const T*>(c), static_cast<const T*>(nrm),
      static_cast<const T*>(area), static_cast<const T*>(diag), static_cast<const T*>(mask),
      static_cast<const T*>(lids), static_cast<const T*>(spot), static_cast<const T*>(us),
      static_cast<const T*>(vs), static_cast<const T*>(wf), static_cast<int>(n),
      static_cast<T*>(R_pot), static_cast<T*>(R_dn));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bem_rankine_f32(const void* pans, const void* c, const void* nrm, const void* area,
                    const void* diag, const void* mask, const void* lids, const void* spot,
                    const void* us, const void* vs, const void* wf, long long n,
                    void* R_pot, void* R_dn, void* stream) {
  return launch<float>(pans, c, nrm, area, diag, mask, lids, spot, us, vs, wf, n,
                       R_pot, R_dn, stream);
}

int bem_rankine_f64(const void* pans, const void* c, const void* nrm, const void* area,
                    const void* diag, const void* mask, const void* lids, const void* spot,
                    const void* us, const void* vs, const void* wf, long long n,
                    void* R_pot, void* R_dn, void* stream) {
  return launch<double>(pans, c, nrm, area, diag, mask, lids, spot, us, vs, wf, n,
                        R_pot, R_dn, stream);
}

}  // extern "C"
