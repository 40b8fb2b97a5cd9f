"""Kernel K1's thread layouts timed in turns on the card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 -m raft_tpu_torch.tools.k1_layouts [--old path/to/solve6.cu]

K1 (``raft_tpu_torch/csrc/solve6.cu``: eight lanes per system, one row a
lane, the block's systems staged through shared memory) is built as the
port builds it and timed against two layouts with one thread per system
and the same arithmetic, built here from the source below:

* ``thread-vector``: each thread reads its own system with 16-byte vector
  loads (neighbouring threads 36 values apart);
* ``thread-staged``: the block's 128 systems are copied into shared memory
  by consecutive threads reading consecutive addresses (a plane at a
  time, rows padded to 37 values against bank conflicts), then each
  thread reads its system from there.

``--old`` adds an older K1 source with the C interface of the port's
first K1 (no adjoint argument), built with the port's flags alone, as it
was (the layouts here add ``-fmad=false``, as K1 does).

Every layout is checked bit for bit against K1 and timed in turns (each
layout in order, then in reverse; 20 calls each, after an L2 flush and a
device spin queued ahead of the start event so the host's enqueue time is
left out) at the sweep's 250 x 200 and at 1,000 x 200 systems in float32
and float64, forward and (for the layouts with an adjoint mode) adjoint,
and K2's 16,384 systems.  ptxas' registers and spills are printed per
build.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from raft_tpu_torch.core import cuda6, nvcc
from raft_tpu_torch.core.cplx import Cx

THREAD_SOURCE = r"""
#include <cuda_runtime.h>
// One thread per system; STAGED picks how the system reaches the thread.
namespace {
constexpr int kThreads = 128;
constexpr int kPad = 37;
template <typename T> struct Vec;
template <> struct Vec<float> {
  using wide = float4; using pair = float2; static constexpr int kWide = 4;
};
template <> struct Vec<double> {
  using wide = double2; using pair = double2; static constexpr int kWide = 2;
};

template <typename T>
__device__ __forceinline__ void load36(const T* __restrict__ p, T (&v)[36]) {
  using W = typename Vec<T>::wide;
  const W* q = reinterpret_cast<const W*>(p);
#pragma unroll
  for (int e = 0; e < 36 / Vec<T>::kWide; ++e) {
    const W u = q[e];
    if constexpr (Vec<T>::kWide == 4) {
      v[4 * e] = u.x; v[4 * e + 1] = u.y; v[4 * e + 2] = u.z; v[4 * e + 3] = u.w;
    } else {
      v[2 * e] = u.x; v[2 * e + 1] = u.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void load6(const T* __restrict__ p, T (&v)[6]) {
  using Q = typename Vec<T>::pair;
  const Q* q = reinterpret_cast<const Q*>(p);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const Q u = q[e];
    v[2 * e] = u.x; v[2 * e + 1] = u.y;
  }
}

template <typename T>
__device__ __forceinline__ void store6(T* __restrict__ p, const T (&v)[6]) {
  using Q = typename Vec<T>::pair;
  Q* q = reinterpret_cast<Q*>(p);
#pragma unroll
  for (int e = 0; e < 3; ++e) q[e] = Q{v[2 * e], v[2 * e + 1]};
}

template <typename T>
__device__ __forceinline__ void stage36(const T* __restrict__ plane, T* s, long long first,
                                        int nsys, long long lane, bool live, T (&v)[36]) {
  __syncthreads();
  for (int e = threadIdx.x; e < nsys * 36; e += kThreads)
    s[(e / 36) * kPad + e % 36] = plane[first * 36 + e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 36; ++e) v[e] = live ? s[threadIdx.x * kPad + e] : T(0);
}

template <typename T>
__device__ __forceinline__ void swap_if(bool c, T& a, T& b) {
  const T ta = a;
  a = c ? b : a;
  b = c ? ta : b;
}

template <typename T, bool FUSED, bool ADJOINT>
__global__ void __launch_bounds__(kThreads)
solve6_kernel(const T* __restrict__ z0r, const T* __restrict__ z0i,
              const T* __restrict__ w, const T* __restrict__ bd,
              const T* __restrict__ fr, const T* __restrict__ fi,
              T* __restrict__ xr, T* __restrict__ xi, long long n, long long nw) {
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  T zr[36], zi[36], ar[36], ai[36], br[6], bi[6];
#if STAGED
  __shared__ T s[kThreads * kPad];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int nsys = static_cast<int>(min(static_cast<long long>(kThreads), n - first));
  const bool live = lane < n;
  stage36(z0r, s, first, nsys, lane, live, zr);
  stage36(z0i, s, first, nsys, lane, live, zi);
  if (!live) return;
#else
  if (lane >= n) return;
  load36(z0r + lane * 36, zr);
  load36(z0i + lane * 36, zi);
#endif
  load6(fr + lane * 6, br);
  load6(fi + lane * 6, bi);
  T wl = T(0);
  const T* __restrict__ bdl = bd;
  if constexpr (FUSED) {
    wl = w[lane % nw];
    bdl = bd + (lane / nw) * 36;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const int e = ADJOINT ? c * 6 + r : r * 6 + c;
      ar[r * 6 + c] = zr[e];
      if constexpr (ADJOINT && FUSED) {
        ai[r * 6 + c] = -zi[e] + wl * (-bdl[e]);
      } else if constexpr (ADJOINT) {
        ai[r * 6 + c] = -zi[e];
      } else if constexpr (FUSED) {
        ai[r * 6 + c] = zi[e] + wl * bdl[e];
      } else {
        ai[r * 6 + c] = zi[e];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
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
      const bool sw = (p == j);
#pragma unroll
      for (int c = k; c < 6; ++c) {
        swap_if(sw, ar[k * 6 + c], ar[j * 6 + c]);
        swap_if(sw, ai[k * 6 + c], ai[j * 6 + c]);
      }
      swap_if(sw, br[k], br[j]);
      swap_if(sw, bi[k], bi[j]);
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
  store6(xr + lane * 6, sol_r);
  store6(xi + lane * 6, sol_i);
}

template <typename T, bool FUSED>
int launch(const void* z0r, const void* z0i, const void* w, const void* bd, const void* fr,
           const void* fi, void* xr, void* xi, long long n, long long nw, long long adjoint,
           void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  const auto s = static_cast<cudaStream_t>(stream);
  auto a = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(z0r), static_cast<const T*>(z0i), static_cast<const T*>(w),
        static_cast<const T*>(bd), static_cast<const T*>(fr), static_cast<const T*>(fi),
        static_cast<T*>(xr), static_cast<T*>(xi), n, nw);
  };
  if (adjoint) a(solve6_kernel<T, FUSED, true>); else a(solve6_kernel<T, FUSED, false>);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {
int solve6_fused_f32(const void* a, const void* b, const void* w, const void* d, const void* f,
                     const void* g, void* x, void* y, long long n, long long nw, long long adj,
                     void* s) { return launch<float, true>(a, b, w, d, f, g, x, y, n, nw, adj, s); }
int solve6_fused_f64(const void* a, const void* b, const void* w, const void* d, const void* f,
                     const void* g, void* x, void* y, long long n, long long nw, long long adj,
                     void* s) { return launch<double, true>(a, b, w, d, f, g, x, y, n, nw, adj, s); }
int solve6_plain_f32(const void* a, const void* b, const void* f, const void* g, void* x,
                     void* y, long long n, long long adj, void* s) {
  return launch<float, false>(a, b, nullptr, nullptr, f, g, x, y, n, 1, adj, s);
}
int solve6_plain_f64(const void* a, const void* b, const void* f, const void* g, void* x,
                     void* y, long long n, long long adj, void* s) {
  return launch<double, false>(a, b, nullptr, nullptr, f, g, x, y, n, 1, adj, s);
}
}
"""

SPIN_CYCLES = 2_000_000
P, I = ctypes.c_void_p, ctypes.c_longlong


def _nvcc(src, out, flags=()) -> ctypes.CDLL:
    """Compile ``src`` into ``out`` with the port's flags and ``flags``,
    print ptxas' registers and spills, and open it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, *flags, "-o",
                           str(out), str(src)], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src}: {proc.stderr[-3000:]}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {out.stem}: {line.split(':', 1)[-1].strip()}")
    return ctypes.CDLL(str(out))


class Layout:
    """A K1/K2 library with ``solve_rao(Z0, w, Bd, F, adjoint)`` and
    ``solve_cx(A, b)`` on the card."""

    def __init__(self, name, lib, has_adjoint=True):
        self.name, self.lib, self.has_adjoint = name, lib, has_adjoint
        extra = [I] if has_adjoint else []
        for fn in (lib.solve6_fused_f32, lib.solve6_fused_f64):
            fn.argtypes, fn.restype = [P] * 8 + [I, I] + extra + [P], ctypes.c_int
        for fn in (lib.solve6_plain_f32, lib.solve6_plain_f64):
            fn.argtypes, fn.restype = [P] * 6 + [I] + extra + [P], ctypes.c_int

    def solve_rao(self, Z0, w, Bd, F, adjoint=False):
        xr, xi = torch.empty_like(F.re), torch.empty_like(F.im)
        f64 = F.re.dtype == torch.float64
        fn = self.lib.solve6_fused_f64 if f64 else self.lib.solve6_fused_f32
        mode = (int(adjoint),) if self.has_adjoint else ()
        nvcc.check(fn(Z0.re.data_ptr(), Z0.im.data_ptr(), w.data_ptr(), Bd.data_ptr(),
                      F.re.data_ptr(), F.im.data_ptr(), xr.data_ptr(), xi.data_ptr(),
                      xr.numel() // 6, w.shape[0], *mode, nvcc.stream_of(F.re.device)),
                   self.name)
        return Cx(xr, xi)

    def solve_cx(self, A, b):
        xr, xi = torch.empty_like(b.re), torch.empty_like(b.im)
        f64 = b.re.dtype == torch.float64
        fn = self.lib.solve6_plain_f64 if f64 else self.lib.solve6_plain_f32
        mode = (0,) if self.has_adjoint else ()
        nvcc.check(fn(A.re.data_ptr(), A.im.data_ptr(), b.re.data_ptr(), b.im.data_ptr(),
                      xr.data_ptr(), xi.data_ptr(), xr.numel() // 6, *mode,
                      nvcc.stream_of(b.re.device)), self.name)
        return Cx(xr, xi)


def time_ms(fn, flush, reps=20) -> float:
    """Mean device time of fn() between two events, each call after an L2
    flush and a spin queued ahead of the start event."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def in_turns(fns: dict, flush) -> dict:
    """Each function timed twice, in order and then in reverse order; the
    mean of the two."""
    names = list(fns)
    t = {name: [] for name in names}
    for name in names + names[::-1]:
        t[name].append(time_ms(fns[name], flush))
    return {name: 0.5 * sum(v) for name, v in t.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs on the card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    old = None
    if len(args) == 2 and args[0] == "--old":
        old = args[1]
    elif args:
        print("usage: python3 -m raft_tpu_torch.tools.k1_layouts [--old solve6.cu]",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30)
    print("card:", out.stdout.strip())
    work = nvcc.BUILD_DIR / "k1_layouts"
    work.mkdir(parents=True, exist_ok=True)
    src = work / "thread.cu"
    src.write_text(THREAD_SOURCE)
    cuda6.build()
    print("  ptxas K1 (csrc/solve6.cu):", *(
        line.split(":", 1)[-1].strip() for line in (nvcc.build_log(cuda6.SPEC) or "").splitlines()
        if "registers" in line or "spill" in line), sep="\n    ")

    class Port:
        name, has_adjoint = "lanes-8", True

        @staticmethod
        def solve_rao(Z0, w, Bd, F, adjoint=False):
            f = cuda6.solve_rao_adjoint if adjoint else cuda6.solve_rao
            return f(Z0, w, Bd, F)

        @staticmethod
        def solve_cx(A, b):
            return cuda6.solve_cx(A, b)

    layouts = [Port] + [Layout(f"thread-{kind}", _nvcc(src, work / f"lib{kind}.so",
                                                       ("-fmad=false", f"-DSTAGED={staged}")))
                        for kind, staged in (("vector", 0), ("staged", 1))]
    if old is not None:
        layouts.append(Layout("old", _nvcc(old, work / "libold.so"), has_adjoint=False))
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(20261017)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        for B in (250, 1000):
            nw = 200
            Z0 = Cx(t(rng.normal(size=(B, nw, 6, 6)) + 6.0 * np.eye(6), dtype),
                    t(rng.normal(size=(B, nw, 6, 6)), dtype))
            Bd = t(0.1 * rng.normal(size=(B, 6, 6)), dtype)
            w = t(np.linspace(0.05, 2.95, nw), dtype)
            F = Cx(t(rng.normal(size=(B, nw, 6)), dtype), t(rng.normal(size=(B, nw, 6)), dtype))
            ref = Port.solve_rao(Z0, w, Bd, F)
            ref_adj = Port.solve_rao(Z0, w, Bd, F, adjoint=True)
            for lay in layouts[1:]:
                x = lay.solve_rao(Z0, w, Bd, F)
                same = bool(torch.equal(x.re, ref.re) and torch.equal(x.im, ref.im))
                line = f"  K1 {name} {B}x{nw}: {lay.name} == lanes-8 bit for bit: {same}"
                if lay.has_adjoint:
                    x = lay.solve_rao(Z0, w, Bd, F, adjoint=True)
                    line += (f"; adjoint {bool(torch.equal(x.re, ref_adj.re))}"
                             f" {bool(torch.equal(x.im, ref_adj.im))}")
                print(line)
            fwd = in_turns({lay.name: (lambda lay=lay: lay.solve_rao(Z0, w, Bd, F))
                            for lay in layouts}, flush)
            adj = in_turns({lay.name: (lambda lay=lay: lay.solve_rao(Z0, w, Bd, F, True))
                            for lay in layouts if lay.has_adjoint}, flush)
            print(f"  K1 {name} {B}x{nw} forward ms: "
                  + ", ".join(f"{k} {v:.5f}" for k, v in fwd.items()))
            print(f"  K1 {name} {B}x{nw} adjoint ms: "
                  + ", ".join(f"{k} {v:.5f}" for k, v in adj.items()))
        n = 16384
        A = Cx(t(rng.normal(size=(n, 6, 6)) + 8.0 * np.eye(6), dtype),
               t(0.3 * rng.normal(size=(n, 6, 6)), dtype))
        b = Cx(t(rng.normal(size=(n, 6)), dtype), t(rng.normal(size=(n, 6)), dtype))
        ref = Port.solve_cx(A, b)
        for lay in layouts[1:]:
            x = lay.solve_cx(A, b)
            print(f"  K2 {name} {n}: {lay.name} == lanes-8 bit for bit: "
                  f"{bool(torch.equal(x.re, ref.re) and torch.equal(x.im, ref.im))}")
        k2 = in_turns({lay.name: (lambda lay=lay: lay.solve_cx(A, b)) for lay in layouts}, flush)
        print(f"  K2 {name} {n} ms: " + ", ".join(f"{k} {v:.5f}" for k, v in k2.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
