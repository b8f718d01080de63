"""The port's ``torch.distributed`` bootstrap from the DMLC_* env contract.

- ``EnvContract.from_env`` equals the JAX package's for the same env;
- ``init_from_env``: a one-worker job is a no-op, a missing tracker
  raises (``tests/test_distributed.py``'s two cases); the backend follows
  the device (NCCL for the card with ``task_id % device_count`` set first,
  gloo for the CPU), a named backend is kept, the rendezvous is
  ``tcp://uri:port+offset`` with a finite timeout;
- ``pod_identity``: the env contract, then an initialized group, then
  ``(0, 1)``, and the raise for ``DMLC_NUM_WORKER`` without
  ``DMLC_TASK_ID``;
- spawned ranks (2 and 4 gloo ranks in fresh interpreters, the DMLC_*
  contract set per rank as the ``tpu-pod`` launcher sets it):
  ``init_from_env`` joins them, ``sync_min(10 + rank) == 10``, and the
  all-reduced ``[rows, label_sum]`` of the ranks' shards equals a
  single-process parse (the port's version of the JAX test's
  ``WORKER_SCRIPT``, without the rabit client);
- the launcher kills every rank when one fails or the deadline passes.
"""

import json
import os
import sys
import textwrap
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmlc_tpu.parallel.distributed import EnvContract as JaxEnvContract
from dmlc_tpu.parallel.distributed import pod_identity as jax_pod_identity
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.parallel import EnvContract, init_from_env, pod_identity, sync_min
from dmlc_tpu_torch.parallel import distributed as port_dist
from dmlc_tpu_torch.parallel.launch import free_port, run_local, worker_env
from dmlc_tpu_torch.utils.check import DMLCError

ENVS = [
    {},
    {"DMLC_NUM_WORKER": "1"},
    {"DMLC_NUM_WORKER": "4", "DMLC_TASK_ID": "3", "DMLC_TRACKER_URI": "10.0.0.1",
     "DMLC_TRACKER_PORT": "9091", "DMLC_ROLE": "worker", "DMLC_NODE_HOST": "host-3"},
    {"DMLC_NUM_WORKER": "2", "DMLC_TASK_ID": "0", "DMLC_TRACKER_URI": "127.0.0.1",
     "DMLC_TRACKER_PORT": "", "DMLC_ROLE": "server"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_env_contract_matches_reference(env):
    assert tuple(EnvContract.from_env(env)) == tuple(JaxEnvContract.from_env(env))


def test_init_from_env_single_worker_noop():
    contract = init_from_env(env={"DMLC_NUM_WORKER": "1"})
    assert contract.num_worker == 1 and not dist.is_initialized()


def test_init_from_env_missing_tracker_raises():
    with pytest.raises(DMLCError, match="DMLC_TRACKER_URI"):
        init_from_env(env={"DMLC_NUM_WORKER": "2"}, device="cpu")


def test_init_from_env_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = {"DMLC_NUM_WORKER": "2", "DMLC_TASK_ID": "1", "DMLC_TRACKER_URI": "127.0.0.1",
           "DMLC_TRACKER_PORT": "9000"}
    with pytest.raises(DMLCError, match="CUDA"):
        init_from_env(env=env)


@pytest.mark.parametrize("device,backend,want", [
    ("cpu", None, "gloo"),
    ("cpu", "mpi", "mpi"),
    ("cuda", None, "nccl"),
    ("cuda", "gloo", "gloo"),
])
def test_init_from_env_maps_the_contract(monkeypatch, device, backend, want):
    """What ``init_process_group`` is given, captured: the backend follows
    the device unless named, the card is ``task_id % device_count``."""
    calls = {}
    monkeypatch.setattr(port_dist.dist, "init_process_group",
                        lambda **kw: calls.update(kw))
    monkeypatch.setattr(port_dist, "group_ready", lambda: False)
    if device == "cuda":  # as on a host with three cards
        monkeypatch.setattr(port_dist, "resolve_device", lambda d: torch.device("cuda", 0))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
        monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.update(card=i))
    env = {"DMLC_NUM_WORKER": "8", "DMLC_TASK_ID": "5", "DMLC_TRACKER_URI": "10.1.2.3",
           "DMLC_TRACKER_PORT": "9091"}
    contract = init_from_env(env=env, device=device, backend=backend,
                             timeout=timedelta(seconds=42))
    assert contract.task_id == 5
    assert calls["backend"] == want
    assert calls["init_method"] == "tcp://10.1.2.3:9092"
    assert (calls["world_size"], calls["rank"]) == (8, 5)
    assert calls["timeout"] == timedelta(seconds=42)
    assert calls.get("card") == (5 % 3 if device == "cuda" else None)


@pytest.mark.parametrize("env,want", [
    ({"DMLC_NUM_WORKER": "4", "DMLC_TASK_ID": "2"}, (2, 4)),
    ({"DMLC_NUM_WORKER": "1", "DMLC_TASK_ID": "0"}, (0, 1)),
    ({}, (0, 1)),
])
def test_pod_identity_env_then_single_host(env, want):
    assert pod_identity(env) == jax_pod_identity(env) == want


def test_pod_identity_num_worker_without_task_id_raises():
    with pytest.raises(DMLCError, match="DMLC_TASK_ID"):
        pod_identity({"DMLC_NUM_WORKER": "2"})


def test_pod_identity_reads_an_initialized_group(monkeypatch):
    """Source 2: a group of more than one rank answers when the env says
    nothing; a group of one does not count (the JAX package's
    ``process_count() > 1``)."""
    monkeypatch.setattr(port_dist, "group_ready", lambda: True)
    monkeypatch.setattr(port_dist.dist, "get_rank", lambda: 2)
    monkeypatch.setattr(port_dist.dist, "get_world_size", lambda: 3)
    assert pod_identity({}) == (2, 3)
    assert pod_identity({"DMLC_NUM_WORKER": "4", "DMLC_TASK_ID": "1"}) == (1, 4)
    monkeypatch.setattr(port_dist.dist, "get_world_size", lambda: 1)
    assert pod_identity({}) == (0, 1)


def test_sync_min_without_a_group_returns_the_value():
    assert not dist.is_initialized()
    assert sync_min(17) == 17


WORKER = textwrap.dedent(r'''
    import json, os, sys
    from datetime import timedelta

    import numpy as np
    import torch

    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.parallel import init_from_env, make_mesh, pod_identity, sync_min
    from dmlc_tpu_torch.parallel.distributed import exit_rank

    contract = init_from_env(device="cpu", timeout=timedelta(seconds=60))
    assert torch.distributed.get_world_size() == contract.num_worker
    assert torch.distributed.get_rank() == contract.task_id
    assert torch.distributed.get_backend() == "gloo"
    rank, world = pod_identity()
    # data plane: shard index = rank
    parser = create_parser(os.environ["DATA"], rank, world, "libsvm", threaded=False)
    rows, label_sum = 0, 0.0
    for block in parser:
        rows += len(block.label)
        label_sum += float(np.sum(block.label))
    parser.close()
    mesh = make_mesh(devices="cpu")
    total = mesh.all_reduce_(torch.tensor([float(rows), label_sum], dtype=torch.float64))
    agreed = sync_min(10 + rank)
    with open(os.path.join(os.environ["OUT"], f"result_{rank}.json"), "w") as f:
        json.dump({"total": total.tolist(), "rows": rows, "agreed": agreed,
                   "identity": [rank, world], "backend": torch.distributed.get_backend()}, f)
    exit_rank()  # destroys the group and skips torch's teardown at exit
''')


def _write_corpus(tmp_path, n_rows=64, seed=7):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n_rows):
        feats = " ".join(f"{j}:{rng.rand():.4f}" for j in range(1, 6))
        lines.append(f"{i % 2} {feats}")
    path = tmp_path / "train.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("nworker", [2, 4])
def test_spawned_ranks_join_and_reduce(tmp_path, nworker):
    data = _write_corpus(tmp_path)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, DATA=data, OUT=str(tmp_path))
    run_local([sys.executable, str(script)], nworker, timeout=120, env=env)
    # the single-process parse
    parser = create_parser(data, 0, 1, "libsvm", threaded=False)
    blocks = list(parser)
    want_rows = sum(len(b.label) for b in blocks)
    want_labels = float(sum(np.sum(b.label) for b in blocks))
    parser.close()
    results = [json.loads((tmp_path / f"result_{r}.json").read_text()) for r in range(nworker)]
    for r, res in enumerate(results):
        assert res["identity"] == [r, nworker] and res["backend"] == "gloo"
        assert res["total"][0] == want_rows == 64
        assert abs(res["total"][1] - want_labels) < 1e-9
        assert res["agreed"] == 10
    # the shards partition the corpus: no dropped or duplicated rows
    assert sum(res["rows"] for res in results) == 64
    assert all(res["rows"] > 0 for res in results)


def test_worker_env_is_the_contract():
    env = worker_env({"KEEP": "1"}, 4, 2, 5001, host="10.0.0.9")
    contract = EnvContract.from_env(env)
    assert env["KEEP"] == "1" and env["DMLC_ROLE"] == "worker"
    assert (contract.num_worker, contract.task_id) == (4, 2)
    assert (contract.tracker_uri, contract.tracker_port) == ("10.0.0.9", 5000)
    assert 1025 < free_port() < 65536


def test_launcher_kills_the_ranks_when_one_fails(tmp_path):
    """Rank 1 exits at once; rank 0 would wait on it for a minute in the
    rendezvous. The launch ends in seconds with every rank stopped, and
    reports both."""
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent('''
        import os, sys
        from datetime import timedelta
        if os.environ["DMLC_TASK_ID"] == "1":
            sys.exit(3)
        from dmlc_tpu_torch.parallel import init_from_env
        init_from_env(device="cpu", timeout=timedelta(seconds=60))
    '''))
    import time

    t0 = time.monotonic()
    with pytest.raises(DMLCError, match="rank 1 \\(exit 3\\)"):
        run_local([sys.executable, str(script)], 2, timeout=60)
    assert time.monotonic() - t0 < 30
    results = run_local([sys.executable, str(script)], 2, timeout=60, check=False)
    assert results[1].returncode == 3 and results[0].returncode != 0


def test_launcher_deadline_kills_a_hung_rank(tmp_path):
    script = tmp_path / "w.py"
    script.write_text("import time\ntime.sleep(60)\n")
    with pytest.raises(TimeoutError, match="still running"):
        run_local([sys.executable, str(script)], 2, timeout=2)
