"""The port's ``sweep`` subcommand against the JAX package's on the CPU, at
the size of ``tests/test_api_extras.py::test_cli_sweep_json`` (4 draft
variants of OC3spar): the rows agree at 1e-9 scale-relative, the iteration
counts are equal and the printed last lines carry the same keys."""
from raft_tpu import cli as jcli

from raft_tpu_torch import cli

from test_torch_cli import _setup, run  # noqa: F401
from test_torch_cli_batch import CPU, check_rows


def test_sweep_matches_jax():
    args = ["sweep", "oc3", "--param", "draft", "--lo", "0.95", "--hi", "1.05", "-n", "4",
            "--wmin", "0.2", "--wmax", "1.4", "--dw", "0.2"]
    got, line = run(cli.main, args + CPU)
    ref, line_ref = run(jcli.main, args)
    check_rows(got, ref, line, line_ref)
