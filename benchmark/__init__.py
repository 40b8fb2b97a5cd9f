"""The benchmark of raft_tpu_torch on the card (see README.md)."""
