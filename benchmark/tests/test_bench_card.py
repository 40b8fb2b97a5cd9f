"""Each cell at its full size on the card, a short window: ``correct``
against the plain reference.  Skips without a CUDA device; on the card:
``python -m pytest benchmark/tests -m card``."""
from __future__ import annotations

import io
import json
import time

import pytest

from benchmark.harness import runner
from conftest import BENCH


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_correct_on_card(name, card):
    out, err = io.StringIO(), io.StringIO()
    res = runner.run(name, 2**31 + 99, 2.0, False, time.perf_counter(), out=out, err=err)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert json.loads(out.getvalue().strip().splitlines()[-1])["correct"] is True
