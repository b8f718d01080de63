"""Kubernetes backend — analog of tracker/dmlc_tracker/kubernetes.py.

Builds Job manifests for scheduler/servers/workers plus a Service for the
scheduler's stable DNS (kubernetes.py:40-63, 102-137). Manifest
construction is pure (testable); submission shells out to kubectl. The
port's copy of the JAX package's ``tracker/kubernetes.py``: the same
manifests.
"""

from __future__ import annotations

import json
import subprocess
from typing import Dict, List


def job_manifest(name: str, image: str, command: List[str],
                 envs: Dict[str, str], replicas: int = 1,
                 cores: int = 1, memory_mb: int = 1024) -> dict:
    env_list = [{"name": k, "value": str(v)} for k, v in sorted(envs.items())]
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name},
        "spec": {
            "completions": replicas,
            "parallelism": replicas,
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": name,
                        "image": image,
                        "command": command,
                        "env": env_list,
                        "resources": {"requests": {
                            "cpu": str(cores),
                            "memory": f"{memory_mb}Mi",
                        }},
                    }],
                },
            },
        },
    }


def scheduler_service_manifest(name: str, port: int) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name},
        "spec": {
            "selector": {"app": name},
            "ports": [{"port": port, "targetPort": port}],
        },
    }


def build_manifests(args, envs: Dict[str, str], image: str = "python:3.11"):
    """All manifests for a PS-style job (kubernetes.py:102-137)."""
    out = []
    base = dict(envs)
    base.update(args.pass_envs)
    name = args.jobname.replace("_", "-")
    scheduler_name = f"{name}-scheduler"
    port = int(base.get("DMLC_PS_ROOT_PORT", "9091"))
    if args.num_servers > 0:
        sched_env = dict(base, DMLC_ROLE="scheduler")
        out.append(job_manifest(scheduler_name, image, args.command, sched_env))
        out.append(scheduler_service_manifest(scheduler_name, port))
        server_env = dict(base, DMLC_ROLE="server")
        out.append(job_manifest(f"{name}-server", image, args.command,
                                server_env, replicas=args.num_servers,
                                cores=args.server_cores,
                                memory_mb=args.server_memory_mb))
    worker_env = dict(base, DMLC_ROLE="worker")
    out.append(job_manifest(f"{name}-worker", image, args.command,
                            worker_env, replicas=args.num_workers,
                            cores=args.worker_cores,
                            memory_mb=args.worker_memory_mb))
    return out


def submit(args):
    def run(nworker: int, nserver: int, envs: Dict[str, str]):
        for manifest in build_manifests(args, envs):
            proc = subprocess.run(
                ["kubectl", "apply", "-f", "-"],
                input=json.dumps(manifest), text=True, capture_output=True)
            if proc.returncode != 0:
                raise RuntimeError(f"kubectl apply failed: {proc.stderr}")

    return run
