"""SSH backend — analog of tracker/dmlc_tracker/ssh.py.

Reads a host file (``ip[:port]`` per line), optionally rsyncs the working
dir (ssh.py:14-22), exports a whitelisted env set plus the DMLC contract,
and launches the command on each host over ssh (ssh.py:77-86).
Command construction is separated from execution so it is testable.
The port's copy of the JAX package's ``tracker/ssh.py``: the same command
lines and the same forwarded variables.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List, Tuple

from dmlc_tpu_torch.tracker.opts import read_host_file

# env whitelist forwarded to remote nodes (ssh.py:24-36)
FORWARD_ENV = [
    "OMP_NUM_THREADS", "LD_LIBRARY_PATH", "PATH", "PYTHONPATH",
    "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "DMLC_INTERFACE",
    "JAX_PLATFORMS", "XLA_FLAGS", "TPU_WORKER_HOSTNAMES",
]


def parse_host(entry: str) -> Tuple[str, int]:
    if ":" in entry:
        host, port = entry.rsplit(":", 1)
        return host, int(port)
    return entry, 22


def build_remote_command(
    command: List[str], envs: Dict[str, str], host: str, workdir: str
) -> str:
    """The shell line run on the remote host (ssh.py:60-86)."""
    exports = []
    for key in FORWARD_ENV:
        if key in os.environ:
            exports.append(f"export {key}={_q(os.environ[key])};")
    for key, value in envs.items():
        exports.append(f"export {key}={_q(str(value))};")
    exports.append(f"export DMLC_NODE_HOST={_q(host)};")
    return " ".join(exports) + f" cd {_q(workdir)}; " + " ".join(command)


def _q(s: str) -> str:
    return "'" + s.replace("'", "'\"'\"'") + "'"


def build_ssh_argv(host: str, port: int, remote_cmd: str) -> List[str]:
    return ["ssh", "-o", "StrictHostKeyChecking=no", "-p", str(port),
            host, remote_cmd]


def sync_dir(local_dir: str, host: str, port: int, remote_dir: str) -> List[str]:
    """rsync argv for shipping the working dir (ssh.py:14-22)."""
    return ["rsync", "-az", "--rsh", f"ssh -o StrictHostKeyChecking=no -p {port}",
            local_dir + "/", f"{host}:{remote_dir}"]


def submit(args):
    hosts = [parse_host(h) for h in read_host_file(args.host_file)]

    def run(nworker: int, nserver: int, envs: Dict[str, str]):
        assert len(hosts) > 0, "ssh backend: empty host file"
        threads = []
        workdir = args.sync_dst_dir or os.getcwd()
        for i in range(nworker + nserver):
            host, port = hosts[i % len(hosts)]
            role = "worker" if i < nworker else "server"
            env = dict(envs)
            env.update(args.pass_envs)
            env["DMLC_ROLE"] = role
            env["DMLC_TASK_ID"] = str(i if role == "worker" else i - nworker)
            env["DMLC_JOB_CLUSTER"] = "ssh"
            if args.sync_dst_dir:
                subprocess.check_call(
                    sync_dir(os.getcwd(), host, port, args.sync_dst_dir))
            argv = build_ssh_argv(
                host, port, build_remote_command(args.command, env, host, workdir))
            t = threading.Thread(target=subprocess.check_call, args=(argv,))
            t.daemon = True
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    return run
