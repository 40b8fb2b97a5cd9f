"""The BEM gradient under ``RAFT_TPU_BEM_PRECISION=bf16``: the port's
``make_bem_fn`` (float32; its solve leaves ``precision`` to the knob, as
the JAX package's does) against the JAX package's ``make_bem_fn`` and
``jax.value_and_grad`` of it, both under the knob, on the 64-panel tile
mesh of ``tests/test_bem_tiles.py`` in deep water, at theta 1.05.

The value (A, B, F) agrees within 0.1 scale-relative, the JAX package's own
bound for its bf16 mode against its f32 (``tests/test_bem_tiles.py``): at
this theta the JAX package's bf16 B is itself 5.2e-2 from its f32 (the
port's 1.7e-2), because its XLA route rounds to bfloat16 after every
operation where the port rounds each assembled matrix once, so the two bf16
values cannot meet 5e-2 of each other here (measured on an x86 CPU: A
1.40e-2, B 6.83e-2, F.re 8.0e-3, F.im 5.1e-3).  The gradient of the JAX
package's test objective agrees within 1e-1 relative (measured 5.7e-3:
12.7727 against 12.7007; the float32 gradient of both is 12.7065).

Its own file, about 70 s serial: ``jax.value_and_grad`` of the JAX
``bem_fn`` traces for about 27 s and compiles for about 30 s (with XLA's
backend optimizations off, which leaves its numbers as they are).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from raft_tpu.hydro import jax_bem
from raft_tpu.hydro import wavetable as jwt

from raft_tpu_torch import convert
from raft_tpu_torch.hydro import torch_bem

from test_torch_bem_precision import tile_mesh

W = np.array([0.7, 1.3])
BETA = 0.0
THETA = 1.05
#: the value: the JAX package's bound for its bf16 mode (see the docstring)
TOL_VALUE = 0.1
#: the gradient, relative
TOL_GRAD = 1e-1


@pytest.fixture(autouse=True)
def _bf16(monkeypatch):
    """The knob at bf16, one intra-op thread."""
    monkeypatch.setenv(torch_bem.PRECISION_ENV, "bf16")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loss(A, B, F):
    """The JAX package's test objective of A, B and F (tests/test_jax_bem.py)."""
    return A.sum() * 1e-6 + B.sum() * 1e-6 + (F.re**2 + F.im**2).sum() * 1e-10


def test_bf16_bem_fn_value_and_gradient_match_jax(monkeypatch):
    tab = convert.wave_tables(jwt.load_tables())
    monkeypatch.setattr(torch_bem.wavetable, "load_tables", lambda: tab)
    bem_fn = torch_bem.make_bem_fn(tile_mesh(), W, depth=0.0, beta=BETA, dtype=torch.float32,
                                   device="cpu")
    theta = torch.tensor(THETA, dtype=torch.float32, requires_grad=True)
    A, B, F = bem_fn(theta)
    (g,) = torch.autograd.grad(loss(A, B, F), theta)

    jfn = jax_bem.make_bem_fn(tile_mesh(), W, depth=0.0, beta=BETA, dtype=jnp.float32)

    def objective(t):
        out = jfn(t)
        return loss(*out), out

    exe = jax.jit(jax.value_and_grad(objective, has_aux=True)).lower(jnp.float32(THETA)).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    (_value, (Aj, Bj, Fj)), gj = exe(jnp.float32(THETA))

    for name, got, want in (("A", A, Aj), ("B", B, Bj), ("F.re", F.re, Fj.re),
                            ("F.im", F.im, Fj.im)):
        err = torch_bem.parity_err(got.detach().numpy(), np.asarray(want))
        assert err <= TOL_VALUE, f"{name}: {err:.3e}"
    gap = abs(float(g) - float(gj)) / abs(float(gj))
    assert np.isfinite(float(g)) and gap <= TOL_GRAD, (float(g), float(gj), gap)
