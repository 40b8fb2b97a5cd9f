"""``RAFT_TPU_BEM_ASSEMBLY`` in the port (``torch_bem.assembly_mode``,
``resolved_assembly``) against the JAX package's parsing
(``raft_tpu.hydro.jax_bem``), with the JAX names mapped to the port's
(``xla`` -> ``"plain"``, ``pallas`` -> ``"kernels"``): the same table of
strings, one warning per process for a malformed value, the explicit
mode's override contract, and ``auto`` by device.  ``solve_bem_jax``
keys its result cache by the resolved route, and on the CPU both values
give the same A/B/F on a 64-panel sphere (1e-12); ``Model(BEM="jax")``
reports the knob's route."""
import os
import warnings

import numpy as np
import pytest
import torch

from raft_tpu.hydro import jax_bem

from raft_tpu_torch.cache import config
from raft_tpu_torch.hydro import torch_bem
from raft_tpu_torch.model import Model, load_design

from test_native_bem import sphere_mesh

JAX_TO_PORT = {"xla": "plain", "pallas": "kernels", "auto": "auto"}
STRINGS = ["", "auto", "AUTO", " xla ", "xla", "XLA", "pallas", " Pallas", "bogus", "xla,pallas",
           "0"]
TOL = 1e-12
OC3 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "raft_tpu", "designs",
                   "OC3spar.yaml")


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.delenv(torch_bem.ASSEMBLY_ENV, raising=False)
    monkeypatch.setenv(config.CACHE_ENV, str(tmp_path / "cache"))
    monkeypatch.setattr(torch_bem, "_assembly_warned", True)     # silence the table's warnings
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # batched LUs of 256 panels and more on the CPU
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("raw", STRINGS)
def test_assembly_mode_parses_as_the_jax_package(raw):
    assert torch_bem.assembly_mode(env=raw) == JAX_TO_PORT[jax_bem.assembly_mode(env=raw)]


@pytest.mark.parametrize("knob", ["", "xla", "pallas", "bogus"])
@pytest.mark.parametrize("mode", [None, "auto", "xla", "pallas", "bogus"])
def test_resolved_assembly_follows_the_jax_contract(monkeypatch, knob, mode):
    monkeypatch.setenv(torch_bem.ASSEMBLY_ENV, knob)
    want = JAX_TO_PORT[jax_bem.resolved_assembly(mode)]        # the JAX side on the CPU
    assert torch_bem.resolved_assembly(mode, device="cpu") == want
    # auto resolves by device: the kernels on a CUDA device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    auto = knob in ("", "bogus") and mode in (None, "auto", "bogus")
    assert torch_bem.resolved_assembly(mode, device="cuda") == ("kernels" if auto else want)
    assert want == "plain" or not auto


def test_the_port_names_and_a_single_warning(monkeypatch):
    assert set(JAX_TO_PORT.values()) - {"auto"} == set(torch_bem.ASSEMBLIES)
    monkeypatch.setattr(torch_bem, "_assembly_warned", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for raw in ("bogus", "nope", "bogus"):
            assert torch_bem.assembly_mode(env=raw) == "auto"
    msgs = [str(c.message) for c in caught]
    assert len(msgs) == 1 and torch_bem.ASSEMBLY_ENV in msgs[0] and "bogus" in msgs[0]


def test_solve_bem_jax_keys_its_cache_by_the_route(monkeypatch, tmp_path):
    panels = sphere_mesh(a=1.0, zc=-3.0, nth=8, naz=8)
    assert len(panels) == 64
    w = np.array([0.6, 1.2])
    ns = tmp_path / "cache" / "torch-bem-jax"
    out = {}
    for knob in ("xla", "pallas", "xla"):
        monkeypatch.setenv(torch_bem.ASSEMBLY_ENV, knob)
        *res, diag = torch_bem.solve_bem_jax(panels, w, beta=0.0, device="cpu",
                                             return_diagnostics=True)
        assert diag["route"] == JAX_TO_PORT[knob]
        assert diag["cached"] == (knob in out)
        out[knob] = res
        assert len(list(ns.glob("*.npz"))) == len(out)
    for got, want in zip(out["pallas"], out["xla"]):
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_model_bem_jax_takes_the_knob(monkeypatch):
    monkeypatch.setenv(torch_bem.ASSEMBLY_ENV, "pallas")
    m = Model(load_design(OC3), w=np.array([0.5, 1.0]), BEM="jax", device="cpu")
    m.calcBEM(dz_max=6.0, da_max=4.0, cache=False)
    assert m.bem_diagnostics["route"] == "kernels"
    monkeypatch.setenv(torch_bem.ASSEMBLY_ENV, "xla")
    m.calcBEM(dz_max=6.0, da_max=4.0, cache=False)
    assert m.bem_diagnostics["route"] == "plain"
