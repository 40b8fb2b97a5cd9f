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
// (padding) source columns are zero.  The plain version is
// raft_tpu_torch/hydro/torch_bem.py::rankine_plain.
//
// What bounds it on an H100.  The TPU kernel evaluates all 766 points for
// every pair and masks all but the pair's own levels; here a pair visits
// only its own levels' points, about 5 contributions a pair on the shipped
// meshes, each an rsqrt and a dozen multiply-adds (a point's position is
// needed once per source panel): bound by writing the 2 n^2 outputs, with
// the operations (f64 at 34 TFLOP/s) taking a comparable time.  About
// 3.5% of the pairs have a level of 36, 144 or 576 points and carry about
// 40% of the contributions.  They cluster: on and
// next to the diagonal, and in the padding rows, whose centroids all sit
// on the first hull panel.  The first version (one thread per pair) ran a
// warp as long as its nearest pair, 3.1-3.3x the trips its pairs needed.
// A block that works through its own tile's near pairs is no cure: the
// heaviest tiles then set the end of the launch (32-row tiles ran 1.7x
// slower than 8-row ones), and small tiles spend the launch in their own
// short serial chains (stage, barrier, classify, store).
//
// Design: one cooperative launch of as many blocks as fit on the card at
// once (raft_tpu_torch/tools/k3_compare.py times it against the port's
// first K3 source).
//   * Far pass, tile by tile (16 field rows x 32 source columns; tiles
//     b, b + G, b + 2G, ... for block b of G): the tile's source side
//     (vertices, centroid, area, diagonal, lid flag, mask, self potential)
//     and field side (centroid, normal) are staged in shared memory with
//     coalesced loads.  A thread takes one source column and two field
//     rows at once, so each point's position serves both.  A pair whose
//     direct and image levels both have at most 9 points (at most 18
//     contributions) is computed in place, in the plain version's order:
//     levels ascending, points in order, a point's direct contribution
//     before its image one.  Every other pair is appended to the block's
//     near list in device memory (one shared atomic per warp and row, by
//     ballot).
//   * A grid-wide barrier, then the near pass: every warp of the launch
//     takes near pairs of all blocks' lists in turn (warp w of W takes
//     pairs w, w + W, ...), so the clustered near work is spread over the
//     whole card.  A pair's contributions, the direct level's points then
//     the image level's, are dealt to the lanes in turn (lane l takes l,
//     l + 32, ...); each lane sums its own in order, a shuffle tree (xor
//     16, 8, 4, 2, 1) adds the lanes, and lane 0 stores.  Which warp takes
//     a pair may vary, but each pair is summed in one fixed order, so two
//     calls give the same bits.
//   * Rounding: the quantities that choose a pair's level (dist, distI,
//     rel, relI) round one operation at a time with the _rn intrinsics,
//     in the plain version's order, so every pair takes the plain
//     version's level.  The rest may contract into fused multiply-adds;
//     each contribution takes ir = rsqrt(r2), ir^3 = ir ir ir.
//   * The near lists and their lengths live in a workspace the wrapper
//     allocates (bem_rankine_workspace_* words of int32); near_count (may
//     be null) receives the number of near pairs, for a check against the
//     plain version's levels; the path passes null.
//   * Storage and arithmetic types are separate template arguments (S, T):
//     f64 and f32 store and compute in one type; the bf16 entry
//     (RAFT_TPU_BEM_PRECISION=bf16) loads __nv_bfloat16, computes in float
//     and rounds each output once with __float2bfloat16_rn, the plain
//     version's bf16 (upcast, compute in float32, round).  Hopper's bf16
//     arithmetic is paired FMA without transcendental units, so the sqrt,
//     rsqrt and division stay float.  The shared-memory tiles hold the
//     arithmetic type: each staged value is read by every row or column of
//     its tile, so it is converted once, when staged, and the inner loops
//     run as in f32 (the bf16 saving is in the global loads and the two
//     n x n stores, half of f32's bytes).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;                   // field rows of a tile
constexpr int kCols = 32;                   // source columns of a tile: a lane each
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;
static_assert(kRows % kWarps == 0 && kRows <= 32, "a tile has 8, 16, 24 or 32 rows");
constexpr int kMaxBlocks = 2048;            // blocks of a launch, at most
constexpr int kNQ = 766;                    // subdivision points of all levels
constexpr int kFarLevel = 1;                // the far pass takes levels 0 and 1 (ns 1, 3)
constexpr int kNQFar = 10;                  // their points
constexpr unsigned kFull = 0xffffffffu;

// first point and point count of each level in the quadrature arrays
// (torch_bem.quad_points: levels 1, 3, 6, 12, then the image-only 24)
__constant__ int kLevelStart[5] = {0, 1, 10, 46, 190};
__constant__ int kLevelCount[5] = {1, 9, 36, 144, 576};

// round-to-nearest operations that are never contracted
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rsqrt_of(double a) { return rsqrt(a); }
__device__ __forceinline__ float rsqrt_of(float a) { return rsqrtf(a); }

// storage -> arithmetic type (bf16 is computed in float), and the store back
__device__ __forceinline__ double up(double x) { return x; }
__device__ __forceinline__ float up(float x) { return x; }
__device__ __forceinline__ float up(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(double* p, double x) { *p = x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// sqrt(x^2 + y^2 + z^2 + 1e-20), rounded as torch_bem._safe_norm rounds it
template <typename T>
__device__ __forceinline__ T safe_norm_rn(T x, T y, T z) {
  return sqrt_rn(add_rn(add_rn(add_rn(mul_rn(x, x), mul_rn(y, y)), mul_rn(z, z)), T(1e-20)));
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

template <typename T>
struct Shared {
  T u[kNQ], v[kNQ], w[kNQ];                 // subdivision points
  T p[12][kCols];                           // the tile's source side, component-major
  T cj[3][kCols], area[kCols], diag[kCols], mask[kCols], spot[kCols];
  bool lid[kCols];
  T ci[3][kRows], ni[3][kRows];             // the tile's field side
  int start[kMaxBlocks + 1];                // first near pair of each block's list
  int count;
};

// point q of a source panel: position and weight
template <typename T>
__device__ __forceinline__ void point(const T* u, const T* v, const T* w, int q,
                                      const T (&p)[12], T area, T& px, T& py, T& pz, T& dA) {
  const T uq = u[q], vq = v[q];
  const T c00 = (T(1) - uq) * (T(1) - vq), c10 = uq * (T(1) - vq);
  const T c11 = uq * vq, c01 = (T(1) - uq) * vq;
  px = c00 * p[0] + c10 * p[3] + c11 * p[6] + c01 * p[9];
  py = c00 * p[1] + c10 * p[4] + c11 * p[7] + c01 * p[10];
  pz = c00 * p[2] + c10 * p[5] + c11 * p[8] + c01 * p[11];
  dA = area * w[q];
}

// one point source of strength dA at p seen from the field point c_i
template <typename T>
__device__ __forceinline__ void contrib(T cx, T cy, T cz, T nx, T ny, T nz,
                                        T px, T py, T pz, T dA, T& pot, T& dn) {
  const T dx = cx - px, dy = cy - py, dz = cz - pz;
  const T r2 = dx * dx + dy * dy + dz * dz;
  if (r2 > T(1e-12)) {
    const T ir = rsqrt_of(r2);
    const T ir3 = ir * ir * ir;
    pot = pot + dA * ir;
    dn = dn + (-dA * ir3) * (dx * nx + dy * ny + dz * nz);
  }
}

// exact self term on the diagonal, column mask, store
template <typename S, typename T>
__device__ __forceinline__ void finish(int i, int j, int n, T pot, T dn, T spot, T lid, T mask,
                                       S* __restrict__ R_pot, S* __restrict__ R_dn) {
  if (i == j) pot = pot + spot * (T(1) + lid);
  const size_t o = static_cast<size_t>(i) * n + j;
  store(R_pot + o, pot * mask);
  store(R_dn + o, dn * mask);
}

// a near pair: tile k of its block's sequence (high 16 bits); row | col << 5 |
// (sel_d + 1) << 10 | (sel_i + 1) << 13 within the tile (low 16 bits)
__device__ __forceinline__ unsigned near_code(int k, int r, int col, int sel_d, int sel_i) {
  return (static_cast<unsigned>(k) << 16) | static_cast<unsigned>(
      r | (col << 5) | ((sel_d + 1) << 10) | ((sel_i + 1) << 13));
}

// the list that holds near pair e: the last lo in [lo, hi) with start[lo] <= e
__device__ __forceinline__ int list_of(const int* start, int lo, int hi, int e) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

// At most 80 registers a thread, so three blocks share an SM: unbounded,
// the far pass's two rows in flight leave room for two in f64.
template <typename S, typename T>
__global__ void __launch_bounds__(kThreads, 3)
rankine_kernel(const S* __restrict__ pans, const S* __restrict__ c, const S* __restrict__ nrm,
               const S* __restrict__ area, const S* __restrict__ diag,
               const S* __restrict__ mask, const bool* __restrict__ lids,
               const S* __restrict__ spot, const S* __restrict__ us,
               const S* __restrict__ vs, const S* __restrict__ wf, int n, int cap,
               S* __restrict__ R_pot, S* __restrict__ R_dn, int* work,
               int* __restrict__ near_count) {
  __shared__ Shared<T> s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blocks = gridDim.x, b = blockIdx.x;
  const int tiles_j = (n + kCols - 1) / kCols, tiles = tiles_j * ((n + kRows - 1) / kRows);
  int* lengths = work;                       // near pairs in each block's list
  unsigned* list = reinterpret_cast<unsigned*>(work + blocks) + static_cast<size_t>(b) * cap;

  if (tid < kNQFar) {
    s.u[tid] = up(us[tid]);
    s.v[tid] = up(vs[tid]);
    s.w[tid] = up(wf[tid]);
  }
  if (tid == 0) s.count = 0;

  // far pass, tile by tile
  for (int k = 0, tile = b; tile < tiles; ++k, tile += blocks) {
    const int i0 = (tile / tiles_j) * kRows, j0 = (tile % tiles_j) * kCols;
    const int ni = min(kRows, n - i0), nj = min(kCols, n - j0);
    __syncthreads();                         // the previous tile is done with s
    for (int e = tid; e < 12 * nj; e += kThreads) s.p[e % 12][e / 12] = up(pans[12 * j0 + e]);
    for (int e = tid; e < 3 * nj; e += kThreads) s.cj[e % 3][e / 3] = up(c[3 * j0 + e]);
    for (int e = tid; e < 3 * ni; e += kThreads) {
      s.ci[e % 3][e / 3] = up(c[3 * i0 + e]);
      s.ni[e % 3][e / 3] = up(nrm[3 * i0 + e]);
    }
    if (tid < nj) {
      s.area[tid] = up(area[j0 + tid]);
      s.diag[tid] = up(diag[j0 + tid]);
      s.mask[tid] = up(mask[j0 + tid]);
      s.spot[tid] = up(spot[j0 + tid]);
      s.lid[tid] = lids[j0 + tid];
    }
    __syncthreads();
    // the thread's pairs: column j, rows warp, warp + 8, ... (kRowsPerWarp)
    const int j = j0 + lane;
    const bool col = lane < nj;
    int sel_d[kRowsPerWarp], sel_i[kRowsPerWarp];
    bool far[kRowsPerWarp];
#pragma unroll
    for (int kr = 0; kr < kRowsPerWarp; ++kr) {
      const int r = warp + kWarps * kr;
      const bool live = col && r < ni;
      int d = -1, im = -1;
      if (live) {
        const T dx = s.ci[0][r] - s.cj[0][lane], dy = s.ci[1][r] - s.cj[1][lane];
        const T dist = safe_norm_rn(dx, dy, s.ci[2][r] - s.cj[2][lane]);
        const T distI = safe_norm_rn(dx, dy, s.ci[2][r] + s.cj[2][lane]);
        const T dg = s.diag[lane];
        const bool ok = dg > T(1e-9);
        d = level_direct(ok ? div_rn(dist, dg) : T(1e9));
        im = level_image(ok ? div_rn(distI, dg) : T(1e9));
        if (i0 + r == j) {
          d = -1;                            // exact self term instead
          if (s.lid[lane]) im = -1;          // lid at z = 0: its image is itself
        }
      }
      const bool near = live && (d > kFarLevel || im > kFarLevel);
      const unsigned ballot = __ballot_sync(kFull, near);
      if (ballot != 0u) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&s.count, __popc(ballot));
        base = __shfl_sync(kFull, base, 0);
        if (near)
          list[base + __popc(ballot & ((1u << lane) - 1u))] = near_code(k, r, lane, d, im);
      }
      sel_d[kr] = d;
      sel_i[kr] = im;
      far[kr] = live && !near;
    }
    // far pass: each point's position once for the thread's rows; levels
    // ascending, points in order, a point's direct contribution before its
    // image one
    T p[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) p[e] = col ? s.p[e][lane] : T(0);
    const T area_j = col ? s.area[lane] : T(0);
    T pot[kRowsPerWarp], dn[kRowsPerWarp];
#pragma unroll
    for (int kr = 0; kr < kRowsPerWarp; ++kr) pot[kr] = dn[kr] = T(0);
    for (int lv = 0; lv <= kFarLevel; ++lv) {
      bool any = false;
#pragma unroll
      for (int kr = 0; kr < kRowsPerWarp; ++kr)
        any |= far[kr] && (sel_d[kr] == lv || sel_i[kr] == lv);
      if (!any) continue;
      const int q0 = kLevelStart[lv], q1 = q0 + kLevelCount[lv];
      for (int q = q0; q < q1; ++q) {
        T px, py, pz, dA;
        point(s.u, s.v, s.w, q, p, area_j, px, py, pz, dA);
#pragma unroll
        for (int kr = 0; kr < kRowsPerWarp; ++kr) {
          const int r = warp + kWarps * kr;
          const T cx = s.ci[0][r], cy = s.ci[1][r], cz = s.ci[2][r];
          const T nx = s.ni[0][r], ny = s.ni[1][r], nz = s.ni[2][r];
          if (far[kr] && sel_d[kr] == lv) contrib(cx, cy, cz, nx, ny, nz, px, py, pz, dA,
                                                  pot[kr], dn[kr]);
          if (far[kr] && sel_i[kr] == lv) contrib(cx, cy, cz, nx, ny, nz, px, py, -pz, dA,
                                                  pot[kr], dn[kr]);
        }
      }
    }
#pragma unroll
    for (int kr = 0; kr < kRowsPerWarp; ++kr)
      if (far[kr])
        finish(i0 + warp + kWarps * kr, j, n, pot[kr], dn[kr], s.spot[lane],
               s.lid[lane] ? T(1) : T(0), s.mask[lane], R_pot, R_dn);
  }
  __syncthreads();
  if (tid == 0) lengths[b] = s.count;
  for (int q = kNQFar + tid; q < kNQ; q += kThreads) {
    s.u[q] = up(us[q]);
    s.v[q] = up(vs[q]);
    s.w[q] = up(wf[q]);
  }
  cg::this_grid().sync();

  // near pass: warp w of the launch takes near pairs w, w + W, ... of all lists
  if (warp == 0) {                           // the lists' starts, by a warp-wide scan
    int carry = 0;
    for (int b0 = 0; b0 < blocks; b0 += 32) {
      const int x = b0 + lane < blocks ? lengths[b0 + lane] : 0;
      int incl = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      if (b0 + lane < blocks) s.start[b0 + lane] = carry + incl - x;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) s.start[blocks] = carry;
  }
  __syncthreads();
  const int total = s.start[blocks];
  const int warps = blocks * kWarps;
  const unsigned* lists = reinterpret_cast<const unsigned*>(work + blocks);
  int e = b * kWarps + warp;
  int owner = e < total ? list_of(s.start, 0, blocks, e) : 0;
  unsigned code = e < total ? lists[static_cast<size_t>(owner) * cap + (e - s.start[owner])] : 0u;
  while (e < total) {
    const int tile = owner + static_cast<int>(code >> 16) * blocks;
    const int i = (tile / tiles_j) * kRows + static_cast<int>(code & 31u);
    const int j = (tile % tiles_j) * kCols + static_cast<int>((code >> 5) & 31u);
    const int sel_d = static_cast<int>((code >> 10) & 7u) - 1;
    const int sel_i = static_cast<int>((code >> 13) & 7u) - 1;
    // everything the pair reads, issued together
    const T cix = up(c[3 * i]), ciy = up(c[3 * i + 1]), ciz = up(c[3 * i + 2]);
    const T nix = up(nrm[3 * i]), niy = up(nrm[3 * i + 1]), niz = up(nrm[3 * i + 2]);
    T p[12];
#pragma unroll
    for (int e2 = 0; e2 < 12; ++e2) p[e2] = up(pans[12 * j + e2]);
    const T area_j = up(area[j]), spot_j = up(spot[j]), mask_j = up(mask[j]);
    const T lid_j = lids[j] ? T(1) : T(0);
    // the next pair's list entry, while this one computes
    const int e_next = e + warps;
    int owner_next = owner;
    unsigned code_next = 0;
    if (e_next < total) {
      owner_next = list_of(s.start, owner, blocks, e_next);
      code_next = lists[static_cast<size_t>(owner_next) * cap + (e_next - s.start[owner_next])];
    }
    const int nd = sel_d >= 0 ? kLevelCount[sel_d] : 0;
    const int nt = nd + (sel_i >= 0 ? kLevelCount[sel_i] : 0);
    const int qd = sel_d >= 0 ? kLevelStart[sel_d] : 0;
    const int qi = (sel_i >= 0 ? kLevelStart[sel_i] : 0) - nd;
    T pot = T(0), dn = T(0);
    for (int k = lane; k < nt; k += 32) {
      const bool img = k >= nd;
      T px, py, pz, dA;
      point(s.u, s.v, s.w, img ? qi + k : qd + k, p, area_j, px, py, pz, dA);
      contrib(cix, ciy, ciz, nix, niy, niz, px, py, img ? -pz : pz, dA, pot, dn);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pot = pot + __shfl_xor_sync(kFull, pot, off);
      dn = dn + __shfl_xor_sync(kFull, dn, off);
    }
    if (lane == 0) finish(i, j, n, pot, dn, spot_j, lid_j, mask_j, R_pot, R_dn);
    e = e_next;
    owner = owner_next;
    code = code_next;
  }
  if (near_count != nullptr && b == 0 && tid == 0) atomicAdd(near_count, total);
}

// blocks of one launch (all resident at once, as a cooperative launch
// needs), its tiles' near-list capacity per block, and the workspace words
template <typename S, typename T>
cudaError_t plan(long long n, int& blocks, int& cap, long long& words) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rankine_kernel<S, T>, kThreads,
                                                        0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = ((n + kCols - 1) / kCols) * ((n + kRows - 1) / kRows);
  long long g = static_cast<long long>(sms) * per_sm;
  if (g > kMaxBlocks) g = kMaxBlocks;
  if (g > tiles) g = tiles;
  const long long per_block = (tiles + g - 1) / g;    // a tile's place in a code: 16 bits
  if (per_block > 65535 || per_block * kRows * kCols > 0x7fffffffLL) return cudaErrorInvalidValue;
  blocks = static_cast<int>(g);
  cap = static_cast<int>(per_block) * kRows * kCols;
  words = g + g * cap;
  return cudaSuccess;
}

template <typename S, typename T>
int launch(const void* pans, const void* c, const void* nrm, const void* area,
           const void* diag, const void* mask, const void* lids, const void* spot,
           const void* us, const void* vs, const void* wf, long long n,
           void* R_pot, void* R_dn, void* work, long long work_words, void* near_count,
           void* stream) {
  if (n == 0) return 0;
  int blocks = 0, cap = 0;
  long long words = 0;
  cudaError_t err = plan<S, T>(n, blocks, cap, words);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (work_words < words) return static_cast<int>(cudaErrorInvalidValue);
  const S *a_pans = static_cast<const S*>(pans), *a_c = static_cast<const S*>(c),
          *a_nrm = static_cast<const S*>(nrm), *a_area = static_cast<const S*>(area),
          *a_diag = static_cast<const S*>(diag), *a_mask = static_cast<const S*>(mask),
          *a_spot = static_cast<const S*>(spot), *a_us = static_cast<const S*>(us),
          *a_vs = static_cast<const S*>(vs), *a_wf = static_cast<const S*>(wf);
  const bool* a_lids = static_cast<const bool*>(lids);
  int a_n = static_cast<int>(n), a_cap = cap;
  S *a_pot = static_cast<S*>(R_pot), *a_dn = static_cast<S*>(R_dn);
  int *a_work = static_cast<int*>(work), *a_count = static_cast<int*>(near_count);
  void* args[] = {&a_pans, &a_c, &a_nrm, &a_area, &a_diag, &a_mask, &a_lids, &a_spot,
                  &a_us, &a_vs, &a_wf, &a_n, &a_cap, &a_pot, &a_dn, &a_work, &a_count};
  err = cudaLaunchCooperativeKernel((const void*)rankine_kernel<S, T>, dim3(blocks),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename T>
long long workspace(long long n) {
  int blocks = 0, cap = 0;
  long long words = 0;
  return plan<S, T>(n, blocks, cap, words) == cudaSuccess ? words : -1;
}

}  // namespace

extern "C" {

// int32 words of the workspace a launch at n panels needs (-1 on a CUDA error)
long long bem_rankine_workspace_f32(long long n) { return workspace<float, float>(n); }
long long bem_rankine_workspace_f64(long long n) { return workspace<double, double>(n); }
long long bem_rankine_workspace_bf16(long long n) { return workspace<__nv_bfloat16, float>(n); }

int bem_rankine_f32(const void* pans, const void* c, const void* nrm, const void* area,
                    const void* diag, const void* mask, const void* lids, const void* spot,
                    const void* us, const void* vs, const void* wf, long long n,
                    void* R_pot, void* R_dn, void* work, long long work_words,
                    void* near_count, void* stream) {
  return launch<float, float>(pans, c, nrm, area, diag, mask, lids, spot, us, vs, wf, n, R_pot,
                              R_dn, work, work_words, near_count, stream);
}

int bem_rankine_f64(const void* pans, const void* c, const void* nrm, const void* area,
                    const void* diag, const void* mask, const void* lids, const void* spot,
                    const void* us, const void* vs, const void* wf, long long n,
                    void* R_pot, void* R_dn, void* work, long long work_words,
                    void* near_count, void* stream) {
  return launch<double, double>(pans, c, nrm, area, diag, mask, lids, spot, us, vs, wf, n, R_pot,
                                R_dn, work, work_words, near_count, stream);
}

int bem_rankine_bf16(const void* pans, const void* c, const void* nrm, const void* area,
                     const void* diag, const void* mask, const void* lids, const void* spot,
                     const void* us, const void* vs, const void* wf, long long n,
                     void* R_pot, void* R_dn, void* work, long long work_words,
                     void* near_count, void* stream) {
  return launch<__nv_bfloat16, float>(pans, c, nrm, area, diag, mask, lids, spot, us, vs, wf, n,
                                      R_pot, R_dn, work, work_words, near_count, stream);
}

}  // extern "C"
