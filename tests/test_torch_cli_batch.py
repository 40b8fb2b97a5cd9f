"""The port's batch subcommands ``dlc`` (with and without ``--bem``) and
``optimize`` against the JAX package's on the CPU, at the sizes of
``tests/test_api_extras.py`` (``sweep`` is in ``tests/test_torch_cli_sweep.py``,
to keep each file under a minute): the returned rows agree at 1e-9
(scale-relative), the iteration counts are equal and the printed last
lines carry the same keys.  ``dlc --bem`` takes the host C++ panel solver
on both sides (the port's ``--bem`` is native unless ``RAFT_TPU_BEM``
names the card's route).  A malformed case table stops both with the same
``SystemExit``.
"""
import numpy as np
import pytest

from raft_tpu import cli as jcli

from raft_tpu_torch import cli

from test_torch_cli import _setup, rel, run  # noqa: F401

CPU = ["--device", "cpu"]
TOL = 1e-9


def check_rows(got, ref, line, line_ref):
    assert set(line) == set(line_ref)
    for key, want in ref.items():
        if key in ("iterations", "param", "params", "columns", "cases", "theta"):
            assert np.array_equal(np.asarray(got[key]), np.asarray(want)), key
        else:
            assert rel(got[key], want) <= TOL, key


@pytest.mark.parametrize("bem", [False, True])
def test_dlc_matches_jax(tmp_path, bem):
    f = tmp_path / "cases.csv"
    if bem:
        f.write_text("6, 10, 0\n6, 10, 40\n")
        args = ["dlc", "oc3", "--cases", str(f), "--bem", "--dz-max", "6", "--da-max", "6",
                "--wmin", "0.3", "--wmax", "1.4", "--dw", "0.3"]
    else:
        f.write_text("# DLC set 1\nHs, Tp, beta_deg\n6, 10, 0\n6, 10, 40\n8, 12, 40\n")
        args = ["dlc", "oc3", "--cases", str(f), "--wmin", "0.2", "--wmax", "1.4", "--dw", "0.2"]
    got, line = run(cli.main, args + CPU)
    ref, line_ref = run(jcli.main, args)
    check_rows(got, ref, line, line_ref)
    assert line["columns"] == ["Hs", "Tp", "beta_rad"]


def test_bad_case_tables_stop_both(tmp_path):
    for text, match in (("6, 10\n6, 10, 40\n", "column"),
                        ("6, 10, 0\nsix, ten, forty\n", "non-numeric"),
                        ("# nothing\n", "no numeric")):
        f = tmp_path / "bad.csv"
        f.write_text(text)
        args = ["dlc", "oc3", "--cases", str(f), "--wmin", "0.2", "--wmax", "1.4", "--dw", "0.2"]
        with pytest.raises(SystemExit, match=match) as e_port:
            cli.main(args + CPU)
        with pytest.raises(SystemExit, match=match) as e_jax:
            jcli.main(args)
        assert str(e_port.value).replace("raft-tpu-torch", "raft-tpu") == str(e_jax.value)


def test_optimize_matches_jax():
    args = ["optimize", "oc3", "--params", "diameter", "draft", "--steps", "2",
            "--wmin", "0.2", "--wmax", "1.4", "--dw", "0.2"]
    got, line = run(cli.main, args + CPU)
    ref, line_ref = run(jcli.main, args)
    assert set(line) == set(line_ref) and got["params"] == ref["params"]
    assert rel(got["theta"], ref["theta"]) <= TOL
    assert rel(got["history"], ref["history"]) <= TOL
    assert abs(got["objective"] - ref["objective"]) <= TOL * abs(ref["objective"])
    assert len(got["history"]) == 3
