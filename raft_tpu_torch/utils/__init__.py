"""Host-side utilities of the port: phase timers and the profiler trace."""
from raft_tpu_torch.utils.profiling import phase, reset, summary, torch_trace  # noqa: F401
