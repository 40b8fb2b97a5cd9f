"""The bf16 assembly mode's coefficients at a water depth of 35 m (the
four-image finite-depth branch), as ``tests/test_torch_bem_precision.py``
checks them in deep water: the port's bf16 (plain assembly, float32 solve)
within ``parity_err`` 0.1 of its f32 and within 5e-2 of the JAX package's
bf16 (its XLA route), A, B and F, both refinement residuals below 1e-4.
The JAX side compiles for about 20 s."""
from test_torch_bem_precision import _one_thread, _own_cache, check_coefficients, tables  # noqa: F401

DEPTH = 35.0


def test_bf16_coefficients_match_jax_finite_depth(tables):  # noqa: F811
    """Measured on an x86 CPU (float32, parity_err of A, B, F.re, F.im):
    the port's bf16 against its f32 5.3e-3, 1.22e-2, 8.1e-4, 2.9e-3;
    against the JAX package's bf16 2.37e-2, 2.21e-2, 3.7e-3, 8.7e-3."""
    check_coefficients(tables, DEPTH)
