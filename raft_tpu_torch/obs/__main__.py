"""``python -m raft_tpu_torch.obs``: the observability smoke (see smoke.py)."""
from raft_tpu_torch.obs.smoke import main

if __name__ == "__main__":
    raise SystemExit(main())
