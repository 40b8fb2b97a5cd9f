"""Host-side YAML access (copy of raft_tpu.io.schema)."""
