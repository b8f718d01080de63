"""dmlc-submit entry point — analog of tracker/dmlc_tracker/submit.py.

The port's copy of the JAX package's ``tracker/submit.py``. Dispatches
every registered cluster (the reference forgot slurm/kubernetes,
submit.py:43-56). YARN keeps its CLI slot but the Java ApplicationMaster is
a non-goal; mesos is dropped (deprecated ecosystem).

Usage::

    python -m dmlc_tpu_torch.tracker.submit --cluster local --num-workers 4 -- cmd...
"""

from __future__ import annotations

import logging
import sys
from typing import List, Optional

from dmlc_tpu_torch.tracker import tracker as tracker_mod
from dmlc_tpu_torch.tracker.opts import parse_opts


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_opts(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level),
        filename=args.log_file,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    if args.cluster == "local":
        from dmlc_tpu_torch.tracker import local as backend
    elif args.cluster == "ssh":
        from dmlc_tpu_torch.tracker import ssh as backend
    elif args.cluster == "mpi":
        from dmlc_tpu_torch.tracker import mpi as backend
    elif args.cluster == "sge":
        from dmlc_tpu_torch.tracker import sge as backend
    elif args.cluster == "slurm":
        from dmlc_tpu_torch.tracker import slurm as backend
    elif args.cluster == "kubernetes":
        from dmlc_tpu_torch.tracker import kubernetes as backend
    elif args.cluster == "tpu-pod":
        from dmlc_tpu_torch.tracker import tpu_pod as backend
    elif args.cluster == "yarn":
        raise SystemExit(
            "dmlc-submit: yarn is a documented non-goal (PARITY.md): the "
            "ApplicationMaster protocol is JVM-only protobuf RPC with no "
            "REST surface, and TPU fleets are provisioned via GKE/TPU pod "
            "tooling instead. Use --cluster kubernetes or --cluster tpu-pod "
            "(same DMLC_* env contract).")
    else:  # pragma: no cover - argparse enforces choices
        raise SystemExit(f"dmlc-submit: unknown cluster {args.cluster!r}")
    fun_submit = backend.submit(args)
    pscmd = " ".join(args.command) if args.num_servers > 0 else None
    tracker_mod.submit(
        args.num_workers, args.num_servers, fun_submit,
        host_ip=args.host_ip, pscmd=pscmd,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
