"""Fresh-interpreter child entry: ``python -m repro_torch.cluster._child a.pkl``.

The master's launch path for heavyweight runners (``start_method =
"spawn"``: they use the card, which a forked child of a process holding
a CUDA context cannot).  A plain subprocess running this module instead
of multiprocessing's spawn start method, because the latter re-executes
the parent's ``__main__`` in every child — wrong (and often fatal) for
plain scripts.

Kept out of the package ``__init__`` so runpy executes it as a true
main module (no double-import warning).
"""

from __future__ import annotations

import pickle
import sys


def main(argv=None) -> None:
    from repro_torch.cluster.worker import worker_main
    with open((argv or sys.argv)[1], "rb") as f:
        d = pickle.load(f)
    # the factory is a SINGLE shared pickle all workers load (a runner's
    # weights ride beside it in a file of their own, loaded with mmap in
    # its setup()); the per-worker args file stays tiny
    with open(d["factory_path"], "rb") as f:
        factory = pickle.load(f)
    worker_main(d["address"], d["wid"], factory,
                d["sleep_per_task"], d["poll"],
                trace=d.get("trace", False), spawned=True)


if __name__ == "__main__":
    main()
