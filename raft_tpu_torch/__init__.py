"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu.

Frequency-domain dynamics of floating offshore wind turbines on PyTorch,
with the TPU kernels of the JAX package rewritten by hand for NVIDIA
Hopper.  It imports neither JAX nor anything of ``raft_tpu``; the JAX
package stays the reference the port is held against.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
