"""The lint audit's reach into the backward pass, on the CPU
(``raft_tpu_torch.lint.audit.backward_probe``): ``val_grad``'s value and
gradient under the audit's counting mode, with a hook on the loss's input
that fires inside the backward.  On the CPU autograd runs the backward on
the calling thread: the hook sees its own 4 ops and 1 host sync, and the
forward's ops plus the backward's less the hook's are the ops the audit
counts for ``val_grad``.  (On the card the backward runs on autograd's
device thread; ``chip_smoke.py`` phase "lint" runs the same probe there.)"""
import torch

from raft_tpu_torch.lint import audit
from raft_tpu_torch.lint.registry import get_entries


def test_backward_probe_on_the_calling_thread():
    res = audit.backward_probe(device="cpu")
    assert res["hook_on_calling_thread"] is True
    assert res["hook_ops_seen"] == res["hook_ops_run"] == audit.PROBE_HOOK_OPS == 4
    assert res["hook_syncs_seen"] == res["hook_syncs_run"] == res["host_syncs"] == 1
    assert res["sync_debug_warnings"] is None
    (entry,) = get_entries(["val_grad"])
    rep = audit.audit_entry(entry, torch.device("cpu"))
    assert res["forward_ops"] > 0 and res["backward_ops"] > res["hook_ops_run"]
    assert res["forward_ops"] + res["backward_ops"] - res["hook_ops_run"] == rep.ops
