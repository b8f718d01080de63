"""Jobs launched by the port's ``tpu-pod`` backend, on the CPU.

The port's counterpart of ``tests/test_distributed.py``'s multi-process
cases, whose JAX side skips here (``jax_multiprocess``: this jaxlib runs
no multi-process collectives). Each job is
``dmlc_tpu_torch.tracker.submit.main(["--cluster", "tpu-pod", ...])`` in
process: the port's ``RabitTracker``, then one fresh interpreter a rank
under the ``DMLC_*`` contract. Each rank makes the rabit rendezvous
(``WorkerClient.start``), heartbeats with ``metrics=True``, joins a gloo
group (``init_from_env(device="cpu")``, rendezvous at the tracker's port
+ 1), resolves ``pod_identity``, agrees on the steps with ``sync_min`` and
steps the data-parallel ``LinearLearner`` over its part.

- 2 and 4 ranks, ELL and dense: the final weights within 1e-5 of the JAX
  learner stepping on the same global batches (each the ranks' batches
  concatenated in rank order; the logic of ``tests/test_distributed.py``
  ``_single_process_reference``), the same bits on every rank, the
  tracker's merged pod table holding every rank;
- recovery (``test_tpu_pod_worker_death_recovery``'s script, ported): task
  1's first life dies hard after the rabit rendezvous, the tracker logs the
  lost rank on ``dmlc_tpu_torch.tracker``, the relaunch (``DMLC_NUM_ATTEMPT``
  1) recovers the same rabit rank, and the weights are the bits of the job
  without the crash;
- ``python -m dmlc_tpu_torch.examples.distributed_pod --device cpu`` in a
  subprocess, with and without ``CRASH=1``.

Every job has a deadline: the submit runs in a thread joined with a
timeout, and each rank ends itself at a watchdog. The ranks run one
intra-op thread each (``OMP_NUM_THREADS=1``): with more, the CPU's
reductions change their bits from job to job, and the recovery case
compares bits across jobs. A job's tracker binds a port picked here with
the port above it free (``_free_pair``), away from 9091, where other
files' trackers start their scan, so that no tracker of another test takes
this job's rendezvous port.
"""

import functools
import json
import logging
import os
import socket
import sys
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from dmlc_tpu.models import LinearLearner as JaxLinearLearner
from dmlc_tpu.models.linear import LinearParams as JaxLinearParams
from dmlc_tpu_torch.parallel.launch import free_port
from dmlc_tpu_torch.tracker import tracker as tracker_mod
from test_torch_parallel_train import B, NUM_COL, _binary_corpus, _global_epoch, _jax_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
JOB_TIMEOUT = 150  # the submit's deadline
RANK_TIMEOUT = 120  # each rank's watchdog
LAYOUTS = ("ell", "dense")

WORKER = textwrap.dedent(r'''
    import hashlib, json, os, sys, threading, time
    from datetime import timedelta

    cfg = json.load(open(sys.argv[1]))
    watchdog = threading.Timer(cfg["rank_timeout"], os._exit, (124,))
    watchdog.daemon = True
    watchdog.start()

    import numpy as np

    from dmlc_tpu_torch import DeviceIter, LinearLearner, convert, create_parser
    from dmlc_tpu_torch.parallel import init_from_env, make_mesh, pod_identity, sync_min
    from dmlc_tpu_torch.parallel.distributed import exit_rank
    from dmlc_tpu_torch.tracker.client import WorkerClient

    task_id = int(os.environ["DMLC_TASK_ID"])
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    out_dir = cfg["out"]
    rank_file = os.path.join(out_dir, f"rabit_rank{task_id}")
    client = WorkerClient(os.environ["DMLC_TRACKER_URI"], int(os.environ["DMLC_TRACKER_PORT"]))
    if cfg["crash"] and task_id == 1 and attempt == 0:
        client.start()
        with open(rank_file, "w") as f:
            f.write(str(client.rank))
        client.start_heartbeat(0.2)
        time.sleep(0.6)  # a few beats, so the tracker tracks this rank
        os._exit(17)     # hard crash: heartbeats stop, no shutdown, no group
    recovered = None
    if attempt > 0 and os.path.exists(rank_file):
        time.sleep(1.6)  # silent past the liveness window
        with open(rank_file) as f:
            old = int(f.read())
        recovered = client.recover(old).rank == old
    else:
        client.start()
    client.start_heartbeat(0.2, metrics=True)
    contract = init_from_env(device="cpu", timeout=timedelta(seconds=60))
    rank, world = pod_identity()
    assert (rank, world) == (contract.task_id, contract.num_worker)
    mesh = make_mesh(devices="cpu")
    init = np.load(cfg["init"])
    out = {"rank": rank, "attempt": attempt, "rabit_rank": client.rank,
           "recovered": recovered, "legs": {}}
    parser = create_parser(cfg["data"], rank, world, "libsvm", threaded=False)
    local = sum(len(b) for b in parser) // cfg["batch"]
    parser.close()
    steps = sync_min(local)
    for layout in cfg["layouts"]:
        model = LinearLearner(cfg["num_col"], layout=layout, learning_rate=0.3, mesh=mesh)
        model.set_params(convert.linear_params_from_jax(init["w"], init["b"], "cpu"))
        it = DeviceIter(create_parser(cfg["data"], rank, world, "libsvm", threaded=False),
                        num_col=model.device_num_col(), batch_size=cfg["batch"], layout=layout,
                        max_nnz=cfg["num_col"], mesh=mesh, shardings=model.batch_shardings(),
                        drop_remainder=True)
        loss, nb = model.fit_epoch(it, max_steps=steps)
        it.close()
        out["legs"][layout] = {
            "steps": nb, "loss": loss,
            "params": [t.detach().numpy().ravel().tolist() for t in model.params],
            "bits": hashlib.sha256(b"".join(t.detach().numpy().tobytes()
                                            for t in model.params)).hexdigest()}
    client.report_metrics()
    out["local"], out["steps"] = local, steps
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    client.stop_heartbeat()
    client.shutdown()
    exit_rank()
''')


def _free_pair() -> int:
    """A port p, below the kernel's ephemeral range, with p and p + 1 free
    a moment ago: the tracker's port and the group's rendezvous."""
    for _ in range(50):
        p = free_port()
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
        return p
    raise RuntimeError("no free pair of ports")


class _Tap(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append((record.name, record.getMessage()))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod_data")
    rng = np.random.default_rng(17)
    w = (0.1 * rng.normal(size=(NUM_COL + 1,))).astype(np.float32)
    w[-1] = 0.0
    init = str(d / "init.npz")
    np.savez(init, w=w, b=np.full((), 0.05, np.float32))
    return {"path": _binary_corpus(d / "binary.libsvm", 1400, 5), "init": init,
            "w": w, "b": np.float32(0.05)}


def _job(data, out, world, crash=False):
    """One tpu-pod job of :data:`WORKER` ranks; its ranks' records and the
    ``dmlc_tpu_torch`` loggers' messages."""
    from dmlc_tpu_torch.tracker.submit import main

    out.mkdir(parents=True, exist_ok=True)
    script = out / "worker.py"
    script.write_text(WORKER)
    cfg = out / "cfg.json"
    cfg.write_text(json.dumps({"data": data["path"], "init": data["init"], "out": str(out),
                               "batch": B, "num_col": NUM_COL, "layouts": LAYOUTS,
                               "crash": crash, "rank_timeout": RANK_TIMEOUT}))
    argv = ["--cluster", "tpu-pod", "--num-workers", str(world), "--host-ip", "127.0.0.1"]
    env = {"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO, "DMLC_METRICS_LOG_EVERY": "0"}
    if crash:
        argv += ["--local-num-attempt", "3"]
        env["DMLC_LIVENESS_TIMEOUT"] = "1.0"
    argv += ["--", sys.executable, str(script), str(cfg)]
    port = _free_pair()
    tap, logger = _Tap(), logging.getLogger("dmlc_tpu_torch")
    failure = []

    def run():
        try:
            main(argv)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            failure.append(exc)

    mp = pytest.MonkeyPatch()
    old_level = logger.level
    try:
        mp.setattr(tracker_mod, "RabitTracker",
                   functools.partial(tracker_mod.RabitTracker, port=port, port_end=port + 1))
        for k, v in env.items():
            mp.setenv(k, v)
        logger.setLevel(logging.INFO)
        logger.addHandler(tap)
        job = threading.Thread(target=run, daemon=True)
        job.start()
        job.join(JOB_TIMEOUT)
    finally:
        logger.removeHandler(tap)
        logger.setLevel(old_level)
        mp.undo()
    assert not job.is_alive(), f"the job ran past {JOB_TIMEOUT} s"
    assert not failure, failure
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    return {"world": world, "ranks": ranks, "log": tap.messages, "port": port}


def _reference(data, world, layout):
    """The JAX learner on the jobs' global batches, one epoch: its
    parameters and step count."""
    batches, _ = _global_epoch(data["path"], world, layout, NUM_COL,
                               NUM_COL + 1 if layout == "dense" else NUM_COL)
    model = JaxLinearLearner(NUM_COL, layout=layout, learning_rate=0.3)
    model.params = JaxLinearParams(jnp.asarray(data["w"]), jnp.asarray(data["b"]))
    model.opt_state = model.opt.init(model.params)
    for arrays in batches:
        model.step(_jax_batch(arrays, layout))
    return [np.asarray(p).ravel() for p in model.params], len(batches)


_JOBS = {}


def _plain_job(data, tmp_path_factory, world):
    """The job of ``world`` ranks without a crash, run once a module."""
    if world not in _JOBS:
        _JOBS[world] = _job(data, tmp_path_factory.mktemp(f"pod{world}"), world)
    return _JOBS[world]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def job(request, data, tmp_path_factory):
    return _plain_job(data, tmp_path_factory, request.param)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pod_job_matches_jax_global_batch_reference(job, data, layout):
    ref_params, ref_steps = _reference(data, job["world"], layout)
    legs = [r["legs"][layout] for r in job["ranks"]]
    assert all(leg["steps"] == ref_steps == r["steps"] for leg, r in zip(legs, job["ranks"]))
    assert ref_steps >= 10
    assert len({leg["bits"] for leg in legs}) == 1
    for got, want in zip(legs[0]["params"], ref_params):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pod_job_brokers_every_rank_and_merges_its_telemetry(job):
    world = job["world"]
    assert sorted(r["rank"] for r in job["ranks"]) == list(range(world))
    assert sorted(r["rabit_rank"] for r in job["ranks"]) == list(range(world))
    msgs = [m for name, m in job["log"] if name == "dmlc_tpu_torch.tracker"]
    assert f"tracker listening on 127.0.0.1:{job['port']}" in msgs
    assert f"@tracker all {world} nodes started" in msgs
    tables = [m for m in msgs if m.startswith("@tracker pod telemetry")]
    assert f"@tracker pod telemetry ({world} rank(s)):" in [t.split("\n")[0] for t in tables]
    rows = tables[-1].split("\n")[2:2 + world]
    assert sorted(int(r.split()[0]) for r in rows) == list(range(world))
    assert any("between node start and job finish" in m for m in msgs)


@pytest.fixture(scope="module")
def recovery(data, tmp_path_factory):
    return _job(data, tmp_path_factory.mktemp("pod_crash"), 2, crash=True)


def test_tpu_pod_worker_death_recovery(recovery, data, tmp_path_factory):
    job = _plain_job(data, tmp_path_factory, 2)
    msgs = recovery["log"]
    lost = [m for name, m in msgs if name == "dmlc_tpu_torch.tracker" and "missed heartbeats" in m]
    assert lost, msgs
    assert any("relaunching 1/3" in m for _, m in msgs)
    by_rank = {r["rank"]: r for r in recovery["ranks"]}
    assert by_rank[1]["attempt"] == 1 and by_rank[1]["recovered"] is True
    assert by_rank[0]["attempt"] == 0
    assert by_rank[1]["rabit_rank"] == int(lost[0].split("rank ")[1].split()[0])
    for layout in LAYOUTS:
        assert ({r["legs"][layout]["bits"] for r in recovery["ranks"]}
                == {r["legs"][layout]["bits"] for r in job["ranks"]})


EXAMPLE = textwrap.dedent('''
    import functools, runpy, sys
    from dmlc_tpu_torch.tracker import tracker as T
    T.RabitTracker = functools.partial(T.RabitTracker, port={port}, port_end={port} + 1)
    sys.argv = ["distributed_pod", "--device", "cpu"]
    runpy.run_module("dmlc_tpu_torch.examples.distributed_pod", run_name="__main__")
''')


@pytest.mark.parametrize("crash", [False, True], ids=["plain", "crash"])
def test_distributed_pod_example_on_the_cpu(crash, tmp_path):
    """The ported example launches itself 2-way through ``tpu-pod`` (its
    tracker on a port of this test's; see the module docstring); with
    ``CRASH=1`` worker 1's first life dies and its relaunch recovers."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    env.pop("CRASH", None)
    if crash:
        env["CRASH"] = "1"
    proc = subprocess.run([sys.executable, "-c", EXAMPLE.format(port=_free_pair())],
                          env=env, cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=JOB_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    acc = [float(line.split("accuracy ")[1].split()[0])
           for line in proc.stdout.splitlines() if "accuracy" in line]
    assert len(acc) == 2 and min(acc) > 0.9 and acc[0] == acc[1], proc.stdout
    assert proc.stdout.count("gloo group up") == 2
    assert proc.stdout.rstrip().endswith("pod job finished")
    if crash:
        assert "simulating mid-job crash" in proc.stdout
        assert "recovered rabit rank" in proc.stdout
        assert "missed heartbeats" in proc.stderr and "relaunching 1/3" in proc.stderr
    assert not any(tmp_path.glob("tmp*/pod.libsvm"))  # the example removed its corpus
