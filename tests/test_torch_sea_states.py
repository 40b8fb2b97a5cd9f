"""The port's sea-state batches (``spreading_weights``, ``make_wave_states``,
``spread_sea_state``, ``mixed_sea_state``, ``sweep_sea_states``,
``directional_response``) against the JAX package's, on CPU in float64.

The staging functions agree to 1e-14.  ``sweep_sea_states`` runs OC3spar
over 4 cases at 24 frequencies on the strip path (cases with their own
headings), with the raw (A, B, F) tuple (one heading) and with a heading
grid interpolated to each case's heading: every output agrees to 1e-12
scale-relative with identical iteration counts (the port runs the cases as
lanes of one batched solve where the JAX package vmaps one case).
"""
import numpy as np
import pytest
import torch

from raft_tpu.core.waves import spreading_weights as jax_spreading_weights
from raft_tpu.parallel.sweep import (directional_response as jax_directional,
                                     make_wave_states as jax_make_wave_states,
                                     mixed_sea_state as jax_mixed_sea_state,
                                     spread_sea_state as jax_spread_sea_state,
                                     sweep_sea_states as jax_sweep_sea_states)

from raft_tpu_torch.core.cplx import Cx
from raft_tpu_torch.core.waves import spreading_weights
from raft_tpu_torch.parallel.sweep import (directional_response, make_wave_states,
                                           mixed_sea_state, spread_sea_state, stage_bem,
                                           sweep_sea_states)

from test_torch_dynamics import _stage

NW = 24
W = np.linspace(0.05, 2.95, NW)
DEPTH = 320.0
ROWS3 = [[4.0, 8.0, 0.0], [6.0, 10.0, 0.4], [8.0, 12.0, 0.8], [10.0, 14.0, 1.2]]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oc3():
    return _stage("OC3spar", NW)


def _close(got, want, rtol=1e-14):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("n_dir,s,max_offset", [(7, 2.0, None), (5, 4.0, 0.8), (1, 2.0, None),
                                                (3, np.inf, None)])
def test_spreading_weights_match_jax(n_dir, s, max_offset):
    got = spreading_weights(n_dir, s, max_offset)
    want = jax_spreading_weights(n_dir, s, max_offset)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert abs(got[1].sum() - 1.0) < 1e-15
    for bad in ({"n_dir": 0}, {"max_offset": 2.0}):
        with pytest.raises(ValueError):
            spreading_weights(**bad)


@pytest.mark.parametrize("rows", [ROWS3, [r[:2] for r in ROWS3], [6.0, 10.0, 0.3]])
def test_make_wave_states_matches_jax(rows):
    got = make_wave_states(W, rows, DEPTH, device="cpu")
    want = jax_make_wave_states(W, rows, DEPTH)
    for name in ("w", "k", "zeta"):
        _close(getattr(got, name), getattr(want, name))
    assert (got.beta is None) == (want.beta is None)
    if want.beta is not None:
        _close(got.beta, want.beta)
    with pytest.raises(ValueError, match="Hs, Tp"):
        make_wave_states(W, [[1.0, 2.0, 3.0, 4.0]], DEPTH, device="cpu")


def test_spread_and_mixed_sea_states_match_jax():
    pairs = [(spread_sea_state(W, 8.0, 12.0, DEPTH, beta0=0.3, n_dir=7, s=3.0, device="cpu"),
              jax_spread_sea_state(W, 8.0, 12.0, DEPTH, beta0=0.3, n_dir=7, s=3.0)),
             (mixed_sea_state(W, [[6.0, 9.0, 0.0], [2.0, 16.0, 1.0]], DEPTH, device="cpu"),
              jax_mixed_sea_state(W, [[6.0, 9.0, 0.0], [2.0, 16.0, 1.0]], DEPTH))]
    for got, want in pairs:
        for name in ("w", "k", "zeta", "beta"):
            _close(getattr(got, name), getattr(want, name))
    # the lanes of a spread sea carry the long-crested variance between them
    spread = pairs[0][0]
    long = make_wave_states(W, [[8.0, 12.0]], DEPTH, device="cpu")
    _close((spread.zeta ** 2).sum(0), long.zeta[0] ** 2, rtol=1e-14)
    with pytest.raises(ValueError, match="Hs, Tp, beta"):
        mixed_sea_state(W, [[6.0, 9.0]], DEPTH, device="cpu")


def _bem(nb=None, seed=5):
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(6)[:, :, None] * 4e6, (1, 1, NW))
    B = np.tile(np.eye(6)[:, :, None] * 2e5, (1, 1, NW))
    shape = (6, NW) if nb is None else (nb, 6, NW)
    return A, B, (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 2e5


@pytest.mark.parametrize("mode", ["strip", "raw", "grid"])
def test_sweep_sea_states_matches_jax(oc3, mode):
    (jm, jrna, jenv, _jw, C), (tm, trna, tenv, _tw, tC) = oc3
    rows = [r[:2] for r in ROWS3] if mode == "raw" else ROWS3
    bem = {"strip": None, "raw": _bem()}.get(mode)
    if mode == "grid":
        A, B, F_all = _bem(nb=4)
        bem = (np.linspace(0.0, 1.5, 4), F_all, A, B)
    want = jax_sweep_sea_states(jm, jrna, jenv, jax_make_wave_states(W, rows, DEPTH), C, bem=bem)
    got = sweep_sea_states(tm, trna, tenv, make_wave_states(W, rows, DEPTH, device="cpu"), tC,
                           bem=bem, device="cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    for key in ("std dev", "nacelle accel std dev", "Xi_abs2"):
        _close(got[key], want[key], rtol=1e-12)


def test_directional_response_matches_jax(oc3):
    """The spread sea's lanes as a DLC table on the strip path, their
    variances summed."""
    (jm, jrna, jenv, _jw, C), (tm, trna, tenv, _tw, tC) = oc3
    want = jax_directional(jm, jrna, jenv, jax_spread_sea_state(W, 8.0, 12.0, DEPTH, n_dir=4), C)
    got = directional_response(tm, trna, tenv,
                               spread_sea_state(W, 8.0, 12.0, DEPTH, n_dir=4, device="cpu"), tC,
                               device="cpu")
    _close(got["std dev"], want["std dev"], rtol=1e-12)
    _close(got["nacelle accel std dev"], want["nacelle accel std dev"], rtol=1e-12)
    np.testing.assert_array_equal(got["per direction"]["iterations"],
                                  want["per direction"]["iterations"])


def test_bem_layouts_and_unported_options_raise(oc3):
    """The JAX package's three layout errors, and the options that are not
    ported name their ROADMAP item."""
    _, (tm, trna, tenv, twave, tC) = oc3
    heading_rows = make_wave_states(W, ROWS3, DEPTH, device="cpu")
    one_heading = make_wave_states(W, [r[:2] for r in ROWS3], DEPTH, device="cpu")
    staged = stage_bem(_bem(), twave)
    assert isinstance(staged[2], Cx)
    for waves, bem, match in ((heading_rows, _bem(), "heading grid"),
                              (one_heading, staged, "stage_bem output")):
        with pytest.raises(ValueError, match=match):
            sweep_sea_states(tm, trna, tenv, waves, tC, bem=bem, device="cpu")
    ragged = make_wave_states(W, ROWS3[:2], DEPTH, device="cpu")
    ragged.w = torch.stack([ragged.w[0], ragged.w[1] * 1.01])
    with pytest.raises(ValueError, match="one shared frequency grid"):
        sweep_sea_states(tm, trna, tenv, ragged, tC, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*multi-device"):
        directional_response(tm, trna, tenv, heading_rows, tC, mesh=object(), device="cpu")
