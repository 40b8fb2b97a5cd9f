"""The bf16 assembly mode of the port's panel solve (``RAFT_TPU_BEM_PRECISION``)
against the JAX package's, on the CPU, deep water.

* The knob parses as the JAX package's (``tests/test_bem_tiles.py``).
* The JAX package's rule: the assembly runs in bfloat16 only on a float32
  solve; an explicit float64 solve gives exactly what ``precision="f32"``
  gives.  The result cache is salted with the precision, and the Model
  rule sends ``Model.calcBEM`` (and ``ArrayModel.calcBEM``) to a float32
  solve with the bf16 assembly under the knob.
* The plain versions' bf16 is the kernels': upcast to float32, compute,
  round once; checked bit for bit on the JAX package's 64-panel tile mesh
  at ``W2 = [0.7, 1.3]``, also through the kernel wrappers' CPU dispatch.
* The coefficients, both packages in float32 on the same padded mesh,
  fit arrays and wave tables: the port's bf16 (plain assembly) within
  ``parity_err`` 0.1 of its f32 (the JAX package's bound for its own bf16,
  ``tests/test_bem_tiles.py``) and within 5e-2 of the JAX package's bf16
  (its XLA route, which rounds to bfloat16 after every operation where the
  port rounds each assembled matrix once), A, B and F; both refinement
  residuals below 1e-4.  The JAX side compiles for about 20 s.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import mesh as jmesh
from raft_tpu.hydro import wavetable as jwt

from raft_tpu_torch import convert
from raft_tpu_torch.core import cuda_bem
from raft_tpu_torch.hydro import torch_bem

DEPTH = 0.0
W2 = np.array([0.7, 1.3])
BETAS = np.array([0.0])
#: the port's bf16 against its f32 (the JAX package's bound for its own bf16)
TOL_SELF = 0.1
#: the port's bf16 against the JAX package's bf16, A, B and F
TOL_JAX = 5e-2
#: both refinement residuals
TOL_RESID = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small and the suite runs several workers at
    once: one intra-op thread each keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_cache(monkeypatch, tmp_path):
    """A result cache of each test's own, and the knob unset."""
    monkeypatch.setenv("RAFT_TPU_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv(torch_bem.PRECISION_ENV, raising=False)


def tile_mesh():
    """The JAX package's bf16 test mesh (``tests/test_bem_tiles.py::_tile_mesh``):
    a column padded to the 64-panel class."""
    return jmesh.mesh_member(stations=[0.0, 8.0], diameters=[2.3, 2.3], rA=[0.0, 0.0, -6.0],
                             rB=[0.0, 0.0, 2.0], dz_max=1.6, da_max=1.3)


@pytest.fixture(scope="module")
def tables():
    return convert.wave_tables(jwt.load_tables())


def _port_solve(tab, precision, dtype=torch.float32, depth=DEPTH):
    padded, pm, lm = torch_bem.pad_mesh(tile_mesh(), None)
    fd = jwt.fd_fit_grid(W2, depth if depth > 0 else -1.0, 9.81)
    staged = torch_bem.stage_inputs(padded, pm, lm, W2, BETAS, fd, finite_depth=depth > 0,
                                    dtype=dtype, device="cpu")
    return torch_bem.solve_panels(**staged, tab=torch_bem.stage_tables(tab, dtype, "cpu"),
                                  depth=depth, finite_depth=depth > 0, assembly="plain",
                                  precision=precision, dtype=dtype, device="cpu")


def _jax_solve(tab, precision, depth=DEPTH):
    padded, pm, lm = jax_bem._pad_mesh(tile_mesh(), None)
    fd = jwt.fd_fit_grid(W2, depth if depth > 0 else -1.0, 9.81)
    f32 = jnp.float32
    return jax_bem.solve_panels(
        jnp.asarray(padded, f32), jnp.asarray(pm, f32), jnp.asarray(lm, f32),
        jnp.asarray(W2, f32), jnp.asarray(BETAS, f32),
        {k: jnp.asarray(v, f32) for k, v in fd.items()},
        {k: jnp.asarray(tab[k], f32) for k in ("I0", "I1")}, depth=depth,
        finite_depth=depth > 0, dtype=f32, assembly="xla", precision=precision)


def _coeffs(out):
    A, B, F, _resid = out
    return [np.asarray(x, dtype=np.float64) for x in (A, B, F.re, F.im)]


def check_coefficients(tab, depth):
    """The coefficient contract of the module docstring at ``depth``; returns
    the measured gaps (port bf16 against port f32, against JAX bf16)."""
    p16 = _port_solve(tab, "bf16", depth=depth)
    p32 = _port_solve(tab, "f32", depth=depth)
    j16 = _jax_solve(tab, "bf16", depth=depth)
    self_gap = [torch_bem.parity_err(a, b) for a, b in zip(_coeffs(p16), _coeffs(p32))]
    jax_gap = [torch_bem.parity_err(a, b) for a, b in zip(_coeffs(p16), _coeffs(j16))]
    for x in _coeffs(p16):
        assert np.isfinite(x).all()
    assert max(self_gap) <= TOL_SELF, self_gap
    assert max(jax_gap) <= TOL_JAX, jax_gap
    assert float(p16[3].max()) < TOL_RESID and float(np.max(np.asarray(j16[3]))) < TOL_RESID
    return self_gap, jax_gap


def test_precision_knob_parsing(monkeypatch):
    """The table of ``tests/test_bem_tiles.py::test_precision_knob_parsing``."""
    assert torch_bem.bem_precision() == "f32"
    for raw, want in [("bf16", "bf16"), ("BFLOAT16", "bf16"), ("f32", "f32"),
                      ("float32", "f32"), ("", "f32"), ("f16", "f32")]:
        monkeypatch.setenv(torch_bem.PRECISION_ENV, raw)
        assert torch_bem.bem_precision() == want
    monkeypatch.delenv(torch_bem.PRECISION_ENV)
    assert torch_bem.bem_precision("bf16") == "bf16"


def test_bf16_applies_to_a_float32_solve_only(tables, monkeypatch):
    """``assembly_dtype``: bfloat16 only for bf16 with a float32 solve; an
    explicit float64 solve under bf16, by argument or by the knob, returns
    exactly the f32-precision solve."""
    assert torch_bem.assembly_dtype("bf16", torch.float32) == torch.bfloat16
    assert torch_bem.assembly_dtype("bf16", torch.float64) == torch.float64
    assert torch_bem.assembly_dtype("f32", torch.float32) == torch.float32
    ref = _port_solve(tables, "f32", dtype=torch.float64)
    got = _port_solve(tables, "bf16", dtype=torch.float64)
    monkeypatch.setenv(torch_bem.PRECISION_ENV, "bf16")
    by_knob = _port_solve(tables, None, dtype=torch.float64)
    for out in (got, by_knob):
        for g, r in zip(_coeffs(out), _coeffs(ref)):
            assert np.array_equal(g, r)


def test_result_cache_keeps_precisions_apart(tables, monkeypatch):
    """A bf16 result is never served to an f32 call (and the f32 result is
    served to the next f32 call); the diagnostics name the precision."""
    monkeypatch.setattr(torch_bem.wavetable, "load_tables", lambda: tables)
    kw = {"beta": 0.0, "depth": DEPTH, "dtype": torch.float32, "device": "cpu",
          "cache": True, "return_diagnostics": True}
    *b16, d16 = torch_bem.solve_bem_jax(tile_mesh(), W2, precision="bf16", **kw)
    *f32, d32 = torch_bem.solve_bem_jax(tile_mesh(), W2, precision="f32", **kw)
    *again, d_again = torch_bem.solve_bem_jax(tile_mesh(), W2, precision="f32", **kw)
    assert (d16["cached"], d32["cached"], d_again["cached"]) == (False, False, True)
    assert d16["precision"] == "bf16" and d16["assembly_dtype"] == "torch.bfloat16"
    assert d32["precision"] == "f32" and d32["assembly_dtype"] == "torch.float32"
    assert not np.array_equal(b16[0], f32[0])
    for g, r in zip(again, f32):
        assert np.array_equal(g, r)


def test_model_rule(tables, monkeypatch):
    """Under ``RAFT_TPU_BEM_PRECISION=bf16`` ``Model.calcBEM`` and
    ``ArrayModel.calcBEM`` solve the on-device BEM in float32 with the bf16
    assembly, as the JAX package's Model does; without it they solve in
    the model's dtype.  The hull is the tile mesh in place of the design's
    (the full-width mesh is the card's work)."""
    from raft_tpu_torch.array import ArrayModel
    from raft_tpu_torch.hydro import mesh
    from raft_tpu_torch.model import Model, load_design

    monkeypatch.setattr(torch_bem.wavetable, "load_tables", lambda: tables)
    monkeypatch.setattr(mesh, "mesh_design", lambda design, **kw: tile_mesh())
    design = load_design("raft_tpu/designs/VolturnUS-S.yaml")
    w = W2

    def diag(model):
        model.setEnv(Hs=8.0, Tp=12.0)
        model.calcBEM(cache=False)
        return model.bem_diagnostics, model.bem

    d64, _ = diag(Model(design, w=w, BEM="jax", device="cpu"))
    assert d64["dtype"] == "torch.float64" and d64["assembly_dtype"] == "torch.float64"
    monkeypatch.setenv(torch_bem.PRECISION_ENV, "bf16")
    d16, bem16 = diag(Model(design, w=w, BEM="jax", device="cpu"))
    assert (d16["dtype"], d16["precision"], d16["assembly_dtype"]) == (
        "torch.float32", "bf16", "torch.bfloat16")
    direct = torch_bem.solve_bem_jax(tile_mesh(), w, beta=0.0, depth=200.0, dtype=torch.float32,
                                     device="cpu", cache=False)
    for g, r in zip(bem16, direct):
        assert np.array_equal(g, r)
    da, _ = diag(ArrayModel(design, nT=2, w=w, BEM="jax", device="cpu"))
    assert (da["dtype"], da["assembly_dtype"]) == ("torch.float32", "torch.bfloat16")


def _bf16_geometry():
    """The tile mesh's geometry in float32 and rounded to bfloat16."""
    padded, pm, lm = torch_bem.pad_mesh(tile_mesh(), None)
    P = torch.as_tensor(padded, dtype=torch.float32)
    c, nrm, area, diag = torch_bem.panel_geometry(P)
    pmt, lmt = torch.as_tensor(pm, dtype=torch.float32), torch.as_tensor(lm, dtype=torch.float32)
    ls = (lmt > 0.5) & (torch.abs(c[:, 2]) < 1e-6 * torch.clamp(diag, min=1e-9))
    spot = torch_bem.self_potential(P, c, nrm)
    bf = tuple(t.to(torch.bfloat16) for t in (P, c, nrm, area, diag, pmt))
    return bf + (ls, spot.to(torch.bfloat16))


def _up(x):
    return torch_bem._cast(x, torch.float32)


def test_plain_bf16_is_float32_rounded_once(tables):
    """``rankine_plain`` and ``wave_plain`` of bf16 inputs equal the f32
    plain versions of the same bf16-rounded inputs, rounded to bf16, bit for
    bit; the kernel wrappers' CPU dispatch gives the same bits."""
    args = _bf16_geometry()
    tab16 = torch_bem.stage_tables(tables, torch.bfloat16, "cpu")
    got = torch_bem.rankine_plain(*args, quad=tab16["quad"])
    want = torch_bem.rankine_plain(*_up(args), quad=_up(tab16["quad"]))
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(torch.bfloat16))
    for g, w in zip(cuda_bem.rankine_assembly(*args, quad=tab16["quad"]), got):
        assert torch.equal(g, w)

    k = torch.as_tensor(W2 * W2 / 9.81, dtype=torch.bfloat16)
    P, c, nrm, area, diag, pm, ls, spot = args
    wargs = (got[0], got[1], c, nrm, area, pm, ls, tab16, k, None)
    kw = {"finite_depth": False, "depth": 0.0}
    got_w = torch_bem.wave_plain(*wargs, **kw)
    want_w = torch_bem.wave_plain(*_up(wargs[:8]), _up(k), None, **kw)
    assert len(got_w) == 4 and all(g.dtype == torch.bfloat16 for g in got_w)
    for g, w in zip(got_w, want_w):
        assert torch.equal(g, w.to(torch.bfloat16))
    for g, w in zip(cuda_bem.wave_assembly(*wargs, **kw), got_w):
        assert torch.equal(g, w)


def test_bf16_coefficients_match_jax_deep(tables):
    """Measured on an x86 CPU (float32, parity_err of A, B, F.re, F.im):
    the port's bf16 against its f32 4.9e-3, 1.27e-2, 7.8e-4, 3.2e-3;
    against the JAX package's bf16 1.95e-2, 2.32e-2, 3.8e-3, 9.2e-3."""
    check_coefficients(tables, DEPTH)


@pytest.mark.parametrize("depth", [0.0, 35.0])
def test_bf16_error_tool_emulates_the_mode(tables, depth):
    """``tools/bf16_error.py`` rounds the assembly's inputs and outputs to
    bfloat16 around the float32 wrappers: with all four parts rounded, a
    float32 solve gives the bf16 mode's coefficients bit for bit (the
    card's attribution of the bf16 error rests on it)."""
    from raft_tpu_torch.tools import bf16_error

    def solve(precision):
        padded, pm, lm = torch_bem.pad_mesh(tile_mesh(), None)
        fd = jwt.fd_fit_grid(W2, depth if depth > 0 else -1.0, 9.81)
        staged = torch_bem.stage_inputs(padded, pm, lm, W2, BETAS, fd, finite_depth=depth > 0,
                                        dtype=torch.float32, device="cpu")
        return torch_bem.solve_panels(**staged, tab=torch_bem.stage_tables(tables, torch.float32,
                                                                           "cpu"),
                                      depth=depth, finite_depth=depth > 0, precision=precision,
                                      dtype=torch.float32, device="cpu")

    mode = solve("bf16")
    with bf16_error.rounded(bf16_error.PARTS):
        emulated = solve("f32")
    for g, w in zip(_coeffs(emulated), _coeffs(mode)):
        assert np.array_equal(g, w)
