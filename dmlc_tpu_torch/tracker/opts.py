"""dmlc-submit argument parsing — analog of tracker/dmlc_tracker/opts.py.

The port's copy of the JAX package's ``tracker/opts.py``: the same
options, choices and defaults.

All clusters registered here are dispatched by submit.py (the reference
registers slurm/kubernetes in opts.py:72-75 but forgets them in
submit.py:43-56 — fixed here), plus the new ``tpu-pod`` backend.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

CLUSTERS = ["local", "ssh", "mpi", "sge", "slurm", "yarn", "kubernetes", "tpu-pod"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dmlc-submit",
        description="Submit a distributed job through the dmlc_tpu tracker.",
    )
    parser.add_argument(
        "--cluster", choices=CLUSTERS,
        default=os.environ.get("DMLC_SUBMIT_CLUSTER"),
        help="Cluster backend (default from DMLC_SUBMIT_CLUSTER).")
    parser.add_argument("--num-workers", type=int, required=True,
                        help="Number of workers.")
    parser.add_argument("--num-servers", type=int, default=0,
                        help="Number of parameter servers (0 = allreduce job).")
    parser.add_argument("--worker-cores", type=int, default=1)
    parser.add_argument("--worker-memory-mb", type=int, default=1024)
    parser.add_argument("--server-cores", type=int, default=1)
    parser.add_argument("--server-memory-mb", type=int, default=1024)
    parser.add_argument("--jobname", default="dmlc-job")
    parser.add_argument("--queue", default="default")
    parser.add_argument("--host-file", default=None,
                        help="File with one 'ip[:port]' per line (ssh/mpi/tpu-pod).")
    parser.add_argument("--host-ip", default=None,
                        help="Tracker bind IP (default: auto-detect).")
    parser.add_argument("--env", action="append", default=[],
                        help="KEY=VALUE to forward to workers (repeatable).")
    parser.add_argument("--local-num-attempt", type=int,
                        default=int(os.environ.get("DMLC_NUM_ATTEMPT", "1")),
                        help="Retry count for failed local workers.")
    parser.add_argument("--sync-dst-dir", default=None,
                        help="rsync the working dir to this path on each host (ssh).")
    parser.add_argument("--log-level", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    parser.add_argument("--log-file", default=None)
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="The command to launch on every node.")
    return parser


def parse_opts(argv: Optional[List[str]] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if not args.cluster:
        raise SystemExit("dmlc-submit: --cluster required (or set DMLC_SUBMIT_CLUSTER)")
    if not args.command:
        raise SystemExit("dmlc-submit: no command given")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    args.pass_envs = {}
    for kv in args.env:
        if "=" not in kv:
            raise SystemExit(f"dmlc-submit: bad --env {kv!r} (need KEY=VALUE)")
        key, value = kv.split("=", 1)
        args.pass_envs[key] = value
    return args


def read_host_file(path: str) -> List[str]:
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                hosts.append(line)
    return hosts
