"""The port's tracker (``dmlc_tpu_torch.tracker``) against the JAX package's.

Every case of ``tests/test_tracker.py``, run through the port, and where
the two packages can meet, through both:

- the tree, star, ring and link maps equal JAX's for the same ``n``, and
  keep the invariants the JAX test checks;
- rendezvous over real in-process sockets with every pairing of tracker
  and client across the packages (port/port, port tracker with JAX
  clients, JAX tracker with port clients): the same assignment per rank
  (parent, world, tree neighbors, ring, links dialed and awaited) as the
  JAX tracker gives JAX clients; lazy world size, ``print``, jobid rank
  stability, multi-round brokering, ``recover``;
- ``parse_opts`` namespaces, host files, the ssh, mpi, sge and slurm
  command lines, the kubernetes manifests, ``tpu_pod.worker_env`` and the
  launcher's environment equal JAX's;
- the ``DMLC_NUM_ATTEMPT`` relaunch, a ``dmlc-submit --cluster local`` job
  of port workers, a worker dying mid-brokering, heartbeats and liveness;
- ``pyproject.toml``'s ``dmlc-submit-torch`` console script names the
  port's ``tracker.submit:main``, whose ``--help`` runs in a process that
  cannot import jax and prints the JAX CLI's options;
- pod telemetry: real worker processes ship snapshots of the port's
  registry; the merged table, ``pod_job_metrics`` and ``pod_decisions``
  equal the JAX tracker's for the same snapshots, sent by either client.

The JAX package's own cases bind trackers from port 9091 upward; every
tracker here binds in a range of its own (``_port``), so the two files can
run at once.
"""

import itertools
import json
import os
import subprocess
import sys
import threading
import time
import zipfile

import pytest

from dmlc_tpu.tracker import RabitTracker as JaxRabitTracker
from dmlc_tpu.tracker import WorkerClient as JaxWorkerClient
from dmlc_tpu.tracker import tracker as JT
from dmlc_tpu.tracker.opts import parse_opts as jax_parse_opts
from dmlc_tpu.tracker.opts import read_host_file as jax_read_host_file
from dmlc_tpu_torch.tracker import RabitTracker, WorkerClient
from dmlc_tpu_torch.tracker import tracker as T
from dmlc_tpu_torch.tracker.opts import CLUSTERS, parse_opts, read_host_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKERS = {"torch": RabitTracker, "jax": JaxRabitTracker}
CLIENTS = {"torch": WorkerClient, "jax": JaxWorkerClient}
PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]  # (tracker, clients)
PAIR_IDS = [f"{t}-tracker-{c}-clients" for t, c in PAIRS]
_PORTS = itertools.count(23000, 40)


def _port() -> int:
    """The start of a port range of this file's own (a tracker binds the
    first free port from there)."""
    return next(_PORTS)


# ---------------- topology ----------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 64])
def test_tree_and_ring_invariants(n):
    tree_map, parent_map = T.get_tree(n)
    assert (tree_map, parent_map) == JT.get_tree(n)
    assert T.get_star(n) == JT.get_star(n)
    for r in range(n):
        assert T.tree_neighbors(r, n) == JT.tree_neighbors(r, n)
        if parent_map[r] >= 0:
            assert r in tree_map[parent_map[r]]
            assert parent_map[r] in tree_map[r]
    ring = T.get_ring(tree_map, parent_map)
    assert ring == JT.get_ring(tree_map, parent_map)
    assert T.find_share_ring(tree_map, parent_map, 0) == JT.find_share_ring(
        tree_map, parent_map, 0)
    seen, cur = [0], 0
    for _ in range(n - 1):
        cur = ring[cur][1]
        seen.append(cur)
    assert sorted(seen) == list(range(n))
    for r in range(n):
        prev, nxt = ring[r]
        assert ring[nxt][0] == r and ring[prev][1] == r


@pytest.mark.parametrize("n", [2, 4, 9, 16])
def test_link_map_renumbering(n):
    tree_map, parent_map, ring_map = T.get_link_map(n)
    assert (tree_map, parent_map, ring_map) == JT.get_link_map(n)
    assert sorted(tree_map) == list(range(n))
    cur, seen = 0, {0}
    for _ in range(n - 1):
        cur = ring_map[cur][1]
        seen.add(cur)
    assert seen == set(range(n))
    for r, neighbors in tree_map.items():
        assert all(0 <= x < n and x != r for x in neighbors)


# ---------------- protocol integration ----------------

def _run_workers(tracker, n, client_cls, world_size_from_first=True, jobids=None):
    """n clients of ``client_cls`` in threads; their (client, assignment)."""
    results = [None] * n
    errors = []

    def work(i):
        try:
            client = client_cls("127.0.0.1", tracker.port,
                                jobid=(jobids[i] if jobids else "NULL"))
            results[i] = (client, client.start(world_size=n if world_size_from_first else -1))
        except Exception as exc:  # noqa: BLE001 - reported by the test
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    return results


def _summary(results) -> list:
    """Each rank's assignment without the addresses: what a tracker of
    either package must broker alike."""
    return sorted((a.rank, a.parent, a.world_size, tuple(sorted(a.tree_neighbors)),
                   a.ring_prev, a.ring_next, len(a.connected_peers), a.num_incoming)
                  for _, a in results)


_JAX_SUMMARIES = {}


def _jax_summary(n: int) -> list:
    """The JAX tracker's assignments to n JAX clients."""
    if n not in _JAX_SUMMARIES:
        tracker = JaxRabitTracker("127.0.0.1", n, port=_port())
        tracker.start(n)
        results = _run_workers(tracker, n, JaxWorkerClient)
        _JAX_SUMMARIES[n] = _summary(results)
        for client, _ in results:
            client.shutdown()
        tracker.join(timeout=30)
        tracker.close()
    return _JAX_SUMMARIES[n]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_tracker_assigns_unique_ranks(n, pair):
    tracker = TRACKERS[pair[0]]("127.0.0.1", n, port=_port())
    tracker.start(n)
    results = _run_workers(tracker, n, CLIENTS[pair[1]])
    assert sorted(a.rank for _, a in results) == list(range(n))
    for _, a in results:
        assert a.world_size == n and a.parent < n
        assert all(0 <= x < n and x != a.rank for x in a.tree_neighbors)
    assert (sum(len(a.connected_peers) for _, a in results)
            == sum(a.num_incoming for _, a in results))
    assert _summary(results) == _jax_summary(n)
    for client, _ in results:
        client.shutdown()
    tracker.join(timeout=30)
    assert tracker.alive() is False
    tracker.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_tracker_lazy_world_size(pair):
    tracker = TRACKERS[pair[0]]("127.0.0.1", 999, port=_port())
    tracker.start(999)
    results = _run_workers(tracker, 3, CLIENTS[pair[1]])
    assert sorted(a.rank for _, a in results) == [0, 1, 2]
    assert all(a.world_size == 3 for _, a in results)
    assert tracker.num_workers == 3
    for client, _ in results:
        client.shutdown()
    tracker.join(timeout=30)
    tracker.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_tracker_print_and_jobid_rank_stability(pair, caplog):
    import logging

    caplog.set_level(logging.INFO)
    tracker = TRACKERS[pair[0]]("127.0.0.1", 2, port=_port())
    tracker.start(2)
    results = _run_workers(tracker, 2, CLIENTS[pair[1]], jobids=["job-a", "job-b"])
    probe = CLIENTS[pair[1]]("127.0.0.1", tracker.port)
    probe.print_to_tracker("hello from test")
    for client, _ in results:
        client.shutdown()
    tracker.join(timeout=30)
    tracker.close()
    assert sorted(a.rank for _, a in results) == [0, 1]
    logger = "dmlc_tpu_torch.tracker" if pair[0] == "torch" else "dmlc_tpu.tracker"
    assert ("hello from test" in [r.getMessage() for r in caplog.records if r.name == logger])


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_tracker_multi_round_brokering_accounting(pair):
    """A client that reports a dial failure in its first brokering round
    and links in round 2 settles the peer's wait_accept: the job ends."""
    tracker = TRACKERS[pair[0]]("127.0.0.1", 2, port=_port())
    tracker.start(2)
    cls = CLIENTS[pair[1]]
    a = cls("127.0.0.1", tracker.port)
    a_result = {}
    ta = threading.Thread(target=lambda: a_result.setdefault("assign", a.start()), daemon=True)
    ta.start()
    time.sleep(0.5)  # A connects first (rank 0, into wait_conn)
    b = cls("127.0.0.1", tracker.port)
    port = b._listen()
    conn = b._hello("start", -1, -1)
    b.rank = conn.recv_int()
    conn.recv_int()
    conn.recv_int()
    num_nn = conn.recv_int()
    neighbors = [conn.recv_int() for _ in range(num_nn)]
    rprev, rnext = conn.recv_int(), conn.recv_int()
    linkset = {r for r in neighbors + [rprev, rnext] if r >= 0}
    conn.send_int(0)
    nconn = conn.recv_int()
    conn.recv_int()
    for _ in range(nconn):
        conn.recv_str(), conn.recv_int(), conn.recv_int()
    assert nconn >= 1
    conn.send_int(nconn)  # every dial "failed"
    conn.send_int(len(linkset))
    for r in linkset:
        conn.send_int(r)
    assert conn.recv_int() == 0
    conn.recv_int()
    conn.send_int(0)
    conn.send_int(port)
    conn.close()
    ta.join(timeout=30)
    assert not ta.is_alive()
    a.shutdown()
    b._hello("shutdown", b.rank, -1).close()
    tracker.join(timeout=30)
    assert tracker.end_time is not None
    tracker.close()
    b.close()
    a.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_tracker_recover_keeps_rank(pair):
    tracker = TRACKERS[pair[0]]("127.0.0.1", 2, port=_port())
    tracker.start(2)
    cls = CLIENTS[pair[1]]
    results = _run_workers(tracker, 2, cls)
    by_rank = {a.rank: client for client, a in results}
    by_rank[1].close()
    recovered = cls("127.0.0.1", tracker.port)
    a1 = recovered.recover(1)
    assert a1.rank == 1 and a1.world_size == 2
    by_rank[0].close()
    relinked = cls("127.0.0.1", tracker.port)
    assert relinked.recover(0).rank == 0
    recovered.shutdown()
    relinked.shutdown()
    tracker.join(timeout=30)
    tracker.close()


# ---------------- opts + backends ----------------

ARGVS = [
    ["--cluster", "local", "--num-workers", "3", "--env", "FOO=bar", "--env", "X=1",
     "--", "python", "train.py", "--lr", "0.1"],
    ["--cluster", "tpu-pod", "--num-workers", "2", "--host-ip", "127.0.0.1",
     "--local-num-attempt", "3", "--", "python", "w.py"],
    ["--cluster", "kubernetes", "--num-workers", "2", "--num-servers", "1",
     "--jobname", "my_job", "--worker-cores", "4", "--server-memory-mb", "2048",
     "python", "train.py"],
    ["--cluster", "ssh", "--num-workers", "4", "--host-file", "hosts", "--sync-dst-dir",
     "/work", "--log-level", "DEBUG", "--log-file", "x.log", "--", "./train"],
]


def test_parse_opts_and_env(monkeypatch):
    monkeypatch.delenv("DMLC_SUBMIT_CLUSTER", raising=False)
    monkeypatch.delenv("DMLC_NUM_ATTEMPT", raising=False)
    args = parse_opts(ARGVS[0])
    assert args.cluster == "local" and args.num_workers == 3
    assert args.pass_envs == {"FOO": "bar", "X": "1"}
    assert args.command == ["python", "train.py", "--lr", "0.1"]
    for argv in ARGVS:
        assert vars(parse_opts(argv)) == vars(jax_parse_opts(argv))
    monkeypatch.setenv("DMLC_SUBMIT_CLUSTER", "tpu-pod")
    monkeypatch.setenv("DMLC_NUM_ATTEMPT", "4")
    argv = ["--num-workers", "2", "cmd"]
    assert vars(parse_opts(argv)) == vars(jax_parse_opts(argv))
    assert parse_opts(argv).local_num_attempt == 4
    monkeypatch.delenv("DMLC_SUBMIT_CLUSTER")
    for bad in (["--num-workers", "2", "cmd"],
                ["--cluster", "local", "--num-workers", "2", "--env", "BAD", "cmd"],
                ["--cluster", "local", "--num-workers", "2"]):
        with pytest.raises(SystemExit) as port_exc:
            parse_opts(bad)
        with pytest.raises(SystemExit) as jax_exc:
            jax_parse_opts(bad)
        assert str(port_exc.value) == str(jax_exc.value)
    from dmlc_tpu.tracker.opts import CLUSTERS as JAX_CLUSTERS

    assert CLUSTERS == JAX_CLUSTERS


def test_host_file(tmp_path):
    p = tmp_path / "hosts"
    p.write_text("10.0.0.1\n# comment\n10.0.0.2:2222\n\n")
    assert read_host_file(str(p)) == jax_read_host_file(str(p)) == ["10.0.0.1", "10.0.0.2:2222"]
    from dmlc_tpu.tracker.ssh import parse_host as jax_parse_host
    from dmlc_tpu_torch.tracker.ssh import parse_host

    for entry in ("10.0.0.2:2222", "10.0.0.1", "host.example:22"):
        assert parse_host(entry) == jax_parse_host(entry)
    assert parse_host("10.0.0.1") == ("10.0.0.1", 22)


def test_ssh_command_construction(monkeypatch):
    from dmlc_tpu.tracker import ssh as jax_ssh
    from dmlc_tpu_torch.tracker import ssh

    monkeypatch.setenv("OMP_NUM_THREADS", "4")
    monkeypatch.setenv("XLA_FLAGS", "it's quoted")
    env = {"DMLC_ROLE": "worker", "DMLC_TASK_ID": "3", "Q": "a'b"}
    remote = ssh.build_remote_command(["python", "train.py"], env, "10.0.0.5", "/work")
    assert remote == jax_ssh.build_remote_command(["python", "train.py"], env, "10.0.0.5",
                                                  "/work")
    assert "export DMLC_ROLE='worker';" in remote
    assert "export DMLC_NODE_HOST='10.0.0.5';" in remote
    assert remote.endswith("cd '/work'; python train.py")
    assert ssh.FORWARD_ENV == jax_ssh.FORWARD_ENV
    assert ssh.build_ssh_argv("10.0.0.5", 22, remote) == jax_ssh.build_ssh_argv(
        "10.0.0.5", 22, remote)
    assert ssh.sync_dir("/src", "h", 2222, "/dst") == jax_ssh.sync_dir("/src", "h", 2222, "/dst")


def test_slurm_mpi_sge_command_construction():
    from dmlc_tpu.tracker import mpi as jax_mpi
    from dmlc_tpu.tracker import sge as jax_sge
    from dmlc_tpu.tracker import slurm as jax_slurm
    from dmlc_tpu_torch.tracker import mpi, sge, slurm

    srun = slurm.build_srun_argv(["./train"], 2, 8, "job-worker")
    assert srun == jax_slurm.build_srun_argv(["./train"], 2, 8, "job-worker")
    assert srun[:1] == ["srun"] and "--ntasks=8" in srun
    for text in ("mpirun (Open MPI) 4.1.2", "HYDRA build details: mpich", "something else"):
        assert mpi.detect_mpi_dialect(text) == jax_mpi.detect_mpi_dialect(text)
    for dialect in ("openmpi", "mpich"):
        for host_file in (None, "hosts"):
            argv = mpi.build_mpirun_argv(["./train"], 4, {"A": "1", "B": 2}, dialect, host_file)
            assert argv == jax_mpi.build_mpirun_argv(["./train"], 4, {"A": "1", "B": 2},
                                                     dialect, host_file)
    assert mpi.build_mpirun_argv(["./train"], 4, {"A": "1"}, "openmpi")[3:5] == ["-x", "A=1"]
    assert mpi.build_mpirun_argv(["./train"], 4, {"A": "1"}, "mpich")[3:6] == ["-env", "A", "1"]
    script = sge.build_run_script(["./train"], {"DMLC_NUM_WORKER": "4"}, "worker")
    assert script == jax_sge.build_run_script(["./train"], {"DMLC_NUM_WORKER": "4"}, "worker")
    assert "export DMLC_TASK_ID=$((SGE_TASK_ID - 1))" in script
    qsub = sge.build_qsub_argv("run.sh", 4, "j", "default", 2)
    assert qsub == jax_sge.build_qsub_argv("run.sh", 4, "j", "default", 2)


def test_kubernetes_manifests():
    from dmlc_tpu.tracker.kubernetes import build_manifests as jax_build_manifests
    from dmlc_tpu.tracker.kubernetes import job_manifest as jax_job_manifest
    from dmlc_tpu_torch.tracker.kubernetes import build_manifests, job_manifest

    envs = {"DMLC_PS_ROOT_URI": "h", "DMLC_PS_ROOT_PORT": "9091"}
    for argv in (ARGVS[2], ["--cluster", "kubernetes", "--num-workers", "3", "--env", "K=v",
                            "--", "python", "t.py"]):
        manifests = build_manifests(parse_opts(argv), envs)
        assert manifests == jax_build_manifests(jax_parse_opts(argv), envs)
    manifests = build_manifests(parse_opts(ARGVS[2]), envs)
    kinds = [(m["kind"], m["metadata"]["name"]) for m in manifests]
    assert ("Service", "my-job-scheduler") in kinds
    worker = [m for m in manifests if m["metadata"]["name"] == "my-job-worker"][0]
    assert worker["spec"]["parallelism"] == 2
    env = {e["name"]: e["value"]
           for e in worker["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["DMLC_ROLE"] == "worker"
    assert job_manifest("n", "img", ["c"], {"B": 1, "A": 2}, 3, 2, 64) == jax_job_manifest(
        "n", "img", ["c"], {"B": 1, "A": 2}, 3, 2, 64)


def test_tpu_pod_worker_env():
    from dmlc_tpu.tracker.tpu_pod import worker_env as jax_worker_env
    from dmlc_tpu_torch.parallel.distributed import EnvContract
    from dmlc_tpu_torch.tracker.tpu_pod import worker_env

    base = {"DMLC_TRACKER_URI": "10.0.0.1", "DMLC_TRACKER_PORT": "9091",
            "DMLC_NUM_WORKER": "4"}
    for task in range(4):
        assert worker_env(base, task) == jax_worker_env(base, task)
    env = worker_env(base, 2)
    assert env["DMLC_TASK_ID"] == "2" and env["DMLC_ROLE"] == "worker"
    assert env["DMLC_JOB_CLUSTER"] == "tpu-pod"
    contract = EnvContract.from_env(env)
    assert (contract.task_id, contract.num_worker, contract.tracker_uri,
            contract.tracker_port) == (2, 4, "10.0.0.1", 9091)


def test_local_exec_retry(tmp_path, caplog):
    import logging

    from dmlc_tpu_torch.tracker.local import exec_cmd

    caplog.set_level(logging.WARNING, logger="dmlc_tpu_torch")
    marker = tmp_path / "tries"
    attempts = tmp_path / "attempts"
    cmd = [sys.executable, "-c",
           f"import os,sys; p={str(marker)!r}; "
           "n = int(open(p).read()) if os.path.exists(p) else 0; "
           "open(p, 'w').write(str(n + 1)); "
           f"open({str(attempts)!r}, 'a').write(os.environ.get('DMLC_NUM_ATTEMPT', '-') + ' '"
           " + os.environ['DMLC_ROLE'] + os.environ['DMLC_TASK_ID'] + "
           "os.environ['DMLC_JOB_CLUSTER'] + ';'); sys.exit(0 if n >= 2 else 1)"]
    exec_cmd(cmd, "worker", 0, {}, num_attempt=5)
    assert marker.read_text() == "3"
    assert attempts.read_text() == "- worker0local;1 worker0local;2 worker0local;"
    assert "relaunching 1/5" in caplog.text and "relaunching 2/5" in caplog.text
    with pytest.raises(RuntimeError, match="failed"):
        exec_cmd([sys.executable, "-c", "import sys; sys.exit(1)"], "worker", 0, {},
                 num_attempt=2)


def _submit_local(main, tmp_path, client_module, n=3):
    worker_code = (
        "import os, sys; sys.path.insert(0, os.environ['REPO'])\n"
        f"from {client_module} import WorkerClient\n"
        "c = WorkerClient(os.environ['DMLC_TRACKER_URI'], int(os.environ['DMLC_TRACKER_PORT']))\n"
        "a = c.start()\n"
        "open(os.path.join(os.environ['OUT'], f'rank_{a.rank}'), 'w').write("
        "os.environ['DMLC_TASK_ID'] + ' ' + os.environ['DMLC_NUM_WORKER'])\n"
        "c.shutdown()\n")
    env_backup = dict(os.environ)
    os.environ.update(REPO=REPO, OUT=str(tmp_path))
    try:
        main(["--cluster", "local", "--num-workers", str(n), "--host-ip", "127.0.0.1",
              "--", sys.executable, "-c", worker_code])
    finally:
        os.environ.clear()
        os.environ.update(env_backup)
    return sorted(p.name for p in tmp_path.glob("rank_*"))


def test_submit_local_end_to_end(tmp_path):
    """A whole dmlc-submit local job through the port: port workers
    rendezvous via the port's tracker."""
    from dmlc_tpu_torch.tracker.submit import main

    assert _submit_local(main, tmp_path, "dmlc_tpu_torch.tracker.client") == [
        "rank_0", "rank_1", "rank_2"]
    tasks = sorted((tmp_path / f"rank_{r}").read_text() for r in range(3))
    assert tasks == ["0 3", "1 3", "2 3"]


def test_submit_module_runs_and_refuses_yarn(tmp_path):
    """``python -m dmlc_tpu_torch.tracker.submit`` runs a job of JAX
    clients (the wire is one), and yarn is refused with JAX's message."""
    env = dict(os.environ, PYTHONPATH=REPO, REPO=REPO, OUT=str(tmp_path))
    worker_code = (
        "import os\n"
        "from dmlc_tpu.tracker.client import WorkerClient\n"
        "c = WorkerClient(os.environ['DMLC_TRACKER_URI'], int(os.environ['DMLC_TRACKER_PORT']))\n"
        "a = c.start()\n"
        "open(os.path.join(os.environ['OUT'], f'rank_{a.rank}'), 'w').write('ok')\n"
        "c.shutdown()\n")
    proc = subprocess.run([sys.executable, "-m", "dmlc_tpu_torch.tracker.submit", "--cluster",
                           "local", "--num-workers", "2", "--host-ip", "127.0.0.1", "--",
                           sys.executable, "-c", worker_code],
                          env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert sorted(p.name for p in tmp_path.glob("rank_*")) == ["rank_0", "rank_1"]
    from dmlc_tpu.tracker.submit import main as jax_main
    from dmlc_tpu_torch.tracker.submit import main

    argv = ["--cluster", "yarn", "--num-workers", "1", "--", "x"]
    with pytest.raises(SystemExit) as port_exc:
        main(argv)
    with pytest.raises(SystemExit) as jax_exc:
        jax_main(argv)
    assert str(port_exc.value) == str(jax_exc.value)


class TestLauncher:
    def test_unpack_archives_with_alias(self, tmp_path):
        from dmlc_tpu.tracker.launcher import unpack_archives as jax_unpack
        from dmlc_tpu_torch.tracker.launcher import unpack_archives

        z = tmp_path / "code.zip"
        with zipfile.ZipFile(z, "w") as zf:
            zf.writestr("pkg/mod.py", "X = 1\n")
        dirs = unpack_archives(f"{z}#libs", dest=str(tmp_path / "port"))
        assert dirs == [str(tmp_path / "port" / "libs")]
        assert (tmp_path / "port" / "libs" / "pkg" / "mod.py").read_text() == "X = 1\n"
        assert jax_unpack(f"{z}#libs", dest=str(tmp_path / "jax")) == [
            str(tmp_path / "jax" / "libs")]
        assert unpack_archives(str(tmp_path / "nope.zip")) == []
        assert unpack_archives(None) == jax_unpack(None) == []

    def test_build_env_maps_tracker_contract(self):
        from dmlc_tpu.tracker.launcher import build_env as jax_build_env
        from dmlc_tpu_torch.tracker.launcher import build_env

        bases = [{"DMLC_TRACKER_URI": "10.0.0.1", "DMLC_TRACKER_PORT": "9091",
                  "DMLC_NUM_WORKER": "8", "DMLC_TASK_ID": "3",
                  "DMLC_EXTRA_PYTHONPATH": "/opt/extra", "PYTHONPATH": "/base"},
                 {"DMLC_TRACKER_URI": "h", "DMLC_TRACKER_PORT": "1",
                  "JAX_COORDINATOR_ADDRESS": "kept:2", "DMLC_EXTRA_LDPATH": "/lib"},
                 {}]
        for base in bases:
            assert build_env(base) == jax_build_env(base)
        env = build_env(bases[0])
        assert env["JAX_COORDINATOR_ADDRESS"] == "10.0.0.1:9091"
        assert env["JAX_NUM_PROCESSES"] == "8" and env["JAX_PROCESS_ID"] == "3"
        assert env["PYTHONPATH"] == "/opt/extra:/base"

    def test_launcher_main_execs_command(self, tmp_path):
        from dmlc_tpu_torch.tracker.launcher import main

        marker = tmp_path / "ran.txt"
        rc = main([sys.executable, "-c", f"open(r'{marker}', 'w').write('ok')"],
                  use_exec=False)
        assert rc == 0 and marker.read_text() == "ok"
        assert main([], use_exec=False) == 2


class TestStartPathWorkerDeath:
    @pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
    def test_worker_dying_mid_start_brokering_fails_alone(self, pair):
        """A worker that hangs up during start brokering fails alone; its
        relaunch (same jobid) re-claims the rank and completes the world."""
        import socket as _socket
        import struct

        tracker = TRACKERS[pair[0]]("127.0.0.1", 2, port=_port())
        tracker.start()
        cls = CLIENTS[pair[1]]
        a = b = None
        try:
            sock = _socket.create_connection(("127.0.0.1", tracker.port), 5)
            sock.sendall(struct.pack("@i", T.MAGIC))
            assert struct.unpack("@i", sock.recv(4))[0] == T.MAGIC
            sock.sendall(struct.pack("@i", -1))
            sock.sendall(struct.pack("@i", 2))
            for s in (b"b", b"start"):
                sock.sendall(struct.pack("@i", len(s)) + s)
            a = cls("127.0.0.1", tracker.port, jobid="a")
            ra = {}
            ta = threading.Thread(target=lambda: ra.setdefault("a", a.start(world_size=2)))
            ta.start()
            time.sleep(0.3)
            sock.close()
            b = cls("127.0.0.1", tracker.port, jobid="b")
            assn_b = b.start(world_size=2)
            ta.join(10)
            assn_a = ra.get("a")
            assert assn_a is not None and assn_a.world_size == 2
            assert {assn_a.rank, assn_b.rank} == {0, 1}
            a.shutdown()
            b.shutdown()
            tracker.join(5)
        finally:
            for c in (a, b):
                if c is not None:
                    c.close()
            tracker.close()


# ---------------- pod telemetry ----------------

WORKER_METRICS = (
    "import sys, os\n"
    "from dmlc_tpu_torch.tracker.client import WorkerClient\n"
    "from dmlc_tpu_torch.utils import telemetry\n"
    "from dmlc_tpu_torch.io import resilience\n"
    "c = WorkerClient('127.0.0.1', int(os.environ['PORT']))\n"
    "a = c.start(world_size=2)\n"
    "telemetry.REGISTRY.counter(telemetry.STAGE_BUSY_METRIC,\n"
    "    stage='parse', pipeline='p').inc(1.5)\n"
    "telemetry.REGISTRY.counter(telemetry.STAGE_BUSY_METRIC,\n"
    "    stage='read', pipeline='p').inc(0.25 * a.rank)\n"
    "with telemetry.scope('p'):\n"
    "    resilience.record_event('retries', a.rank)\n"
    "telemetry.record_span('parse', 0.0, 1.5)\n"
    "c.report_metrics()\n"
    "c.shutdown()\n")


def _snapshots() -> dict:
    """Per-rank snapshots with every section the table and the pod sums
    read (stages, resilience, spans, jobs, decisions)."""
    return {
        0: {"telemetry_schema_version": 2, "stages": {"parse": 1.5, "read": 0.0,
                                                      "convert": 0.75},
            "resilience": {"retries": 2, "resumes": 1}, "spans": {"parse": 3},
            "jobs": {"train": {"input_wait_seconds": 0.5, "parts": 2}},
            "decisions": {"autotune.grow": 3, "store.evict": 1}, "spans_dropped": 0},
        1: {"telemetry_schema_version": 2, "stages": {"parse": 1.25, "read": 0.5},
            "resilience": {}, "spans": {"parse": 1},
            "jobs": {"train": {"input_wait_seconds": 0.25, "parts": 1},
                     "eval": {"input_wait_seconds": 1.0, "parts": 4}},
            "decisions": {"autotune.grow": 1}, "spans_dropped": 2},
    }


class TestPodMetrics:
    def test_multiprocess_workers_merge_per_rank_stage_table(self, tmp_path, monkeypatch):
        """Two real worker processes of the port record telemetry and ship
        it over the ``metrics`` command; the port's tracker merges the
        per-rank × per-stage table."""
        monkeypatch.setenv("DMLC_METRICS_LOG_EVERY", "0")
        tracker = RabitTracker("127.0.0.1", 2, port=_port())
        tracker.start(2)
        env = dict(os.environ, PYTHONPATH=REPO, PORT=str(tracker.port))
        procs = [subprocess.Popen([sys.executable, "-c", WORKER_METRICS], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for _ in range(2)]
        try:
            for p in procs:
                _, err = p.communicate(timeout=60)
                assert p.returncode == 0, err
            tracker.join(timeout=30)
            deadline = time.monotonic() + 5
            while len(tracker.pod_metrics()) < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            pod = tracker.pod_metrics()
            assert sorted(pod) == [0, 1]
            for rank in (0, 1):
                assert pod[rank]["telemetry_schema_version"] >= 1
                assert pod[rank]["stages"]["parse"] == pytest.approx(1.5)
                assert pod[rank]["spans"]["parse"] >= 1
            assert pod[1]["stages"]["read"] == pytest.approx(0.25)
            assert pod[1]["resilience"]["retries"] == 1
            lines = tracker.format_pod_table().splitlines()
            assert "rank" in lines[0] and "parse" in lines[0]
            assert any(ln.strip().startswith("0") for ln in lines[1:])
            assert any(ln.strip().startswith("1") for ln in lines[1:])
            assert "3.000" in lines[-1]
            # the JAX tracker's table of the same snapshots
            jax = JaxRabitTracker("127.0.0.1", 1, port=_port())
            for rank, snap in pod.items():
                jax._ingest_metrics(rank, json.dumps(snap))
            assert tracker.format_pod_table() == jax.format_pod_table()
            jax.close()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            tracker.close()

    @pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
    def test_pod_table_and_sums_equal_jax_for_the_same_snapshots(self, pair, monkeypatch):
        """The same snapshots, reported over the wire by clients of either
        package, give the JAX tracker's table, ``pod_job_metrics`` and
        ``pod_decisions``."""
        monkeypatch.setenv("DMLC_METRICS_LOG_EVERY", "0")
        snaps = _snapshots()
        tracker = TRACKERS[pair[0]]("127.0.0.1", 2, port=_port())
        tracker.start(2)
        results = _run_workers(tracker, 2, CLIENTS[pair[1]])
        for client, a in results:
            client.report_metrics(snaps[a.rank])
        deadline = time.monotonic() + 5
        while len(tracker.pod_metrics()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        reference = JaxRabitTracker("127.0.0.1", 1, port=_port())
        for rank, snap in snaps.items():
            reference._ingest_metrics(rank, json.dumps(snap))
        try:
            assert tracker.pod_metrics() == reference.pod_metrics() == snaps
            assert tracker.format_pod_table() == reference.format_pod_table()
            assert tracker.pod_job_metrics() == reference.pod_job_metrics() == {
                "train": {"input_wait_seconds": 0.75, "parts": 3},
                "eval": {"input_wait_seconds": 1.0, "parts": 4}}
            assert tracker.pod_decisions() == reference.pod_decisions() == {
                "autotune.grow": 4, "store.evict": 1}
        finally:
            for client, _ in results:
                client.shutdown()
            tracker.join(timeout=30)
            tracker.close()
            reference.close()

    def test_heartbeat_thread_with_metrics(self):
        """start_heartbeat(metrics=True): the periodic ping doubles as a
        snapshot feed and still counts for liveness."""
        tracker = RabitTracker("127.0.0.1", 1, port=_port(), liveness_timeout=5.0)
        tracker.start(1)
        w = WorkerClient("127.0.0.1", tracker.port)
        try:
            a = w.start(world_size=1)
            w.start_heartbeat(interval=0.1, metrics=True)
            deadline = time.monotonic() + 5
            while a.rank not in tracker.pod_metrics() and time.monotonic() < deadline:
                time.sleep(0.05)
            snap = tracker.pod_metrics().get(a.rank)
            assert snap is not None and snap["telemetry_schema_version"] >= 1
            assert a.rank in tracker.last_seen
            w.stop_heartbeat()
            w.shutdown()
            tracker.join(10)
        finally:
            w.close()
            tracker.close()


class TestLiveness:
    @pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
    def test_silent_worker_flagged_heartbeater_not(self, pair):
        lost = []
        tracker = TRACKERS[pair[0]]("127.0.0.1", 2, port=_port(), liveness_timeout=0.6,
                                    on_worker_lost=lost.append)
        tracker.start()
        cls = CLIENTS[pair[1]]
        a = cls("127.0.0.1", tracker.port, jobid="a")
        b = cls("127.0.0.1", tracker.port, jobid="b")
        try:
            ra = {}
            ta = threading.Thread(target=lambda: ra.setdefault("a", a.start(world_size=2)))
            ta.start()
            assn_b = b.start(world_size=2)
            ta.join(5)
            assn_a = ra["a"]
            a.start_heartbeat(interval=0.2)
            b.heartbeat()
            time.sleep(1.5)
            assert assn_b.rank in tracker.lost_workers
            assert assn_a.rank not in tracker.lost_workers
            assert lost == [assn_b.rank]
            b.heartbeat()
            time.sleep(0.1)
            assert assn_b.rank not in tracker.lost_workers
            a.stop_heartbeat()
            a.shutdown()
            b.shutdown()
            tracker.join(5)
        finally:
            a.close()
            b.close()
            tracker.close()

    def test_never_heartbeating_worker_not_flagged(self):
        tracker = RabitTracker("127.0.0.1", 1, port=_port(), liveness_timeout=0.3)
        tracker.start()
        w = WorkerClient("127.0.0.1", tracker.port)
        try:
            w.start(world_size=1)
            time.sleep(1.0)
            assert tracker.lost_workers == set()
            w.shutdown()
            tracker.join(5)
        finally:
            w.close()
            tracker.close()

    def test_submit_fails_fast_when_ranks_exit_without_shutdown(self):
        """All worker processes exited but a rank never sent shutdown: the
        port's ``submit`` raises JAX's error instead of waiting forever."""
        def fun_submit(nworker, nserver, envs):
            client = WorkerClient(envs["DMLC_TRACKER_URI"], int(envs["DMLC_TRACKER_PORT"]))
            client.start(world_size=1)
            client.close()  # no shutdown

        with pytest.raises(RuntimeError, match="not all ranks sent shutdown"):
            T.submit(1, 0, fun_submit, host_ip="127.0.0.1")


def test_console_script_runs_help_without_jax():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        scripts = [ln.split("=", 1) for ln in f if ln.startswith("dmlc-submit")]
    entries = {k.strip(): v.strip().strip('"') for k, v in scripts}
    assert entries == {"dmlc-submit": "dmlc_tpu.tracker.submit:main",
                       "dmlc-submit-torch": "dmlc_tpu_torch.tracker.submit:main"}
    out = {}
    for name, entry in entries.items():
        module, _, func = entry.partition(":")
        block = "'jax', 'jaxlib', 'dmlc_tpu'" if name.endswith("-torch") else ""
        script = ("import sys\n"
                  f"for name in ({block}):\n"
                  "    sys.modules[name] = None\n"
                  f"import {module} as m\n"
                  "sys.argv = ['dmlc-submit', '--help']\n"
                  f"m.{func}()\n")
        proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                              text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stderr
        out[name] = proc.stdout
    assert "usage: dmlc-submit" in out["dmlc-submit-torch"] and "--cluster" in out["dmlc-submit"]
    assert out["dmlc-submit-torch"] == out["dmlc-submit"]
