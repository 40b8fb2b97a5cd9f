"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu.

Frequency-domain dynamics of floating offshore wind turbines on PyTorch,
with the TPU kernels of the JAX package rewritten by hand for NVIDIA
Hopper.  It imports neither JAX nor anything of ``raft_tpu``; the JAX
package stays the reference the port is held against.  Entry points run on
the card unless the caller passes ``device="cpu"``.

The entry points below load on first use, so ``import raft_tpu_torch``
stays light: ``Model``, ``run_raft``, ``sweep_north_star``,
``forward_response``, ``grad_response_std``, ``grad_nacelle_accel_std`` and
``optimize_design``; the multi-device layer ``init_multihost``,
``global_mesh``, ``stage_global``, ``make_mesh``,
``forward_response_freq_sharded`` and ``forward_response_dp_sp``; and the
coefficient type ``HydroCoeffs``.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "Model": "raft_tpu_torch.model",
    "run_raft": "raft_tpu_torch.model",
    "sweep_north_star": "raft_tpu_torch.parallel.sweep",
    "forward_response": "raft_tpu_torch.parallel.sweep",
    "grad_response_std": "raft_tpu_torch.parallel.sweep",
    "grad_nacelle_accel_std": "raft_tpu_torch.parallel.optimize",
    "optimize_design": "raft_tpu_torch.parallel.optimize",
    "HydroCoeffs": "raft_tpu_torch.core.types",
    "init_multihost": "raft_tpu_torch.parallel.multihost",
    "global_mesh": "raft_tpu_torch.parallel.multihost",
    "stage_global": "raft_tpu_torch.parallel.multihost",
    "make_mesh": "raft_tpu_torch.parallel.sweep",
    "forward_response_freq_sharded": "raft_tpu_torch.parallel.sweep",
    "forward_response_dp_sp": "raft_tpu_torch.parallel.sweep",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
