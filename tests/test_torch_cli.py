"""The port's runRAFT facade (``raft_tpu_torch.cli``) against the JAX
package's (``raft_tpu.cli``) on the CPU.

``analyze`` (the default subcommand) on OC3spar on a coarse grid: the
returned results agree at 1e-9 (natural frequencies elementwise, std dev
and offsets scale-relative, iteration counts equal) and the printed last
line parses as JSON with the same keys.  The port takes ``--device cpu``;
without CUDA its default device raises, so nothing runs on the CPU
silently (``tests/test_torch_isolation.py::
test_cli_and_bem_inputs_refuse_cpu_fallback``).  Both parsers accept the
same option strings, the port's plus ``--device``.  The batch subcommands are in
``tests/test_torch_cli_batch.py``.  ``RAFT_TPU_CACHE_DIR=off`` keeps the
JAX package's CLI from configuring a persistent compile cache.
"""
import io
import json
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from raft_tpu import cli as jcli

from raft_tpu_torch import cache, cli

GRID = ["--wmin", "0.2", "--wmax", "1.2", "--dw", "0.2"]
TOL = 1e-9


@pytest.fixture(autouse=True)
def _setup(monkeypatch, tmp_path):
    """One intra-op thread, the JAX package's compile cache off, the port's
    cache root under ``tmp_path``, the BEM knobs unset; the cache that
    ``main`` enables is disabled again after each test."""
    monkeypatch.setenv("RAFT_TPU_CACHE_DIR", "off")
    monkeypatch.setenv("RAFT_TPU_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    for knob in ("RAFT_TPU_BEM", "RAFT_TPU_BEM_PRECISION"):
        monkeypatch.delenv(knob, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    cache.disable()


def run(main, args):
    """``main(args)``: (returned results, the printed last line as JSON)."""
    out = io.StringIO()
    with redirect_stdout(out):
        res = main(args)
    return res, json.loads(out.getvalue().strip().splitlines()[-1])


def keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= keys(v, prefix + k + "/")
    return out


def rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_analyze_matches_jax():
    got, line = run(cli.main, ["oc3", *GRID, "--json", "--device", "cpu"])
    ref, line_ref = run(jcli.main, ["oc3", *GRID, "--json"])
    np.testing.assert_allclose(got["eigen"]["frequencies"], ref["eigen"]["frequencies"],
                               rtol=TOL)
    for key in ("std dev", "nacelle acceleration std dev", "fairlead tension std dev"):
        assert rel(got["response"][key], ref["response"][key]) <= TOL, key
    assert rel(got["means"]["platform offset"], ref["means"]["platform offset"]) <= TOL
    assert got["response"]["iterations"] == ref["response"]["iterations"]
    assert keys(line) == keys(line_ref)
    assert rel(line["response"]["std dev"], line_ref["response"]["std dev"]) <= TOL


def test_main_flushes_the_ledger_when_it_returns(tmp_path):
    """The kernels' timings of a run persist under the root: ``main``
    flushes the ledger as it returns (a launch fed directly stands in for
    the card's, which the CPU path does not time)."""
    from raft_tpu_torch.obs import ledger

    ledger.reset()
    cache.enable(str(tmp_path / "cache"))
    ledger.record("solve6_fused", "1x1:float64", "NVIDIA H100", "float64", 1e6, 1e5, 1e-5)
    run(cli.main, ["oc3", *GRID, "--json", "--device", "cpu"])
    got = [e for e in ledger.entries() if e["entry"] == "solve6_fused"]
    assert len(got) == 1 and got[0]["count"] == 1 and not ledger.pending()
    ledger.reset()


def test_analyze_report_without_json(capsys):
    cli.main(["oc3", *GRID, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "natural frequencies" in out and "response std dev" in out


def _options(main, argv):
    """The option strings ``main``'s parser for ``argv`` lists in its help."""
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        main(argv + ["--help"])
    return set(re.findall(r"(?<![\w-])(--?[a-z][\w-]*)", out.getvalue()))


@pytest.mark.parametrize("sub", [[], ["sweep"], ["dlc"], ["optimize"]])
def test_parsers_accept_the_same_options(sub):
    port = _options(cli.main, sub)
    ref = _options(jcli.main, sub)
    assert port - ref == {"--device"} and ref <= port


def test_bundled_names_and_dispatch(tmp_path, monkeypatch):
    assert cli._BUNDLED == jcli._BUNDLED
    for name in cli._BUNDLED:
        assert open(cli._design_path(name)).read() == open(jcli._design_path(name)).read()
    assert cli._design_path("some/path.yaml") == "some/path.yaml"
    # a design file named like a subcommand is analyzed, not dispatched
    monkeypatch.chdir(tmp_path)
    (tmp_path / "sweep").write_text(open(cli._design_path("oc3")).read())
    got, _line = run(cli.main, ["sweep", *GRID, "--json", "--device", "cpu"])
    assert "eigen" in got
