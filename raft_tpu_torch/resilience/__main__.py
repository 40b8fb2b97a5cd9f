"""``python -m raft_tpu_torch.resilience``: the resilience smoke
(:mod:`raft_tpu_torch.resilience.smoke`).  ``--child <out.npz>`` is the
internal entry the smoke's subprocess steps re-invoke."""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        if len(argv) != 2:
            print("usage: python -m raft_tpu_torch.resilience [--child OUT.npz]",
                  file=sys.stderr)
            return 2
        from raft_tpu_torch.resilience.smoke import _smoke_child

        return _smoke_child(argv[1])
    if argv:
        print("usage: python -m raft_tpu_torch.resilience [--child OUT.npz]",
              file=sys.stderr)
        return 2
    from raft_tpu_torch.resilience.smoke import _smoke

    return _smoke()


if __name__ == "__main__":
    sys.exit(main())
