"""Multi-process distributed training via dmlc-submit --cluster tpu-pod.

The port of the repository's ``examples/distributed_pod.py``: the whole
distributed recipe in one file, runnable on one host (each rank a process
of its own, the same code path a job of many hosts takes):

    python -m dmlc_tpu_torch.examples.distributed_pod [--device cpu]

It launches itself 2-way (``NWORKER`` ranks). Without ``--device`` every
rank runs on the card.

What happens:
 1. the launcher (``dmlc_tpu_torch.tracker.submit``, cluster ``tpu-pod``)
    starts the rabit tracker and spawns one worker process per "host" with
    the DMLC_* env contract (tracker/dmlc_tracker/tracker.py:178-184 is
    the reference analog);
 2. each worker makes the rabit rendezvous with the tracker
    (:class:`~dmlc_tpu_torch.tracker.client.WorkerClient`), starts its
    heartbeat (each beat carrying its telemetry snapshot), then calls
    :func:`dmlc_tpu_torch.parallel.init_from_env`, which maps the contract
    onto ``torch.distributed.init_process_group`` (rendezvous at the
    tracker's host, port + 1). The example picks the backend in the open:
    gloo on the CPU, and on the card NCCL when there is a card for every
    rank, gloo when ranks share one (NCCL refuses two ranks on one card);
 3. each worker parses ITS OWN InputSplit shard (shard index = task id),
    feeds batches through ``DeviceIter``, and the data-parallel
    ``LinearLearner`` all-reduces its gradients across the ranks.

Elastic recovery demo (the reference's retry + recover contract,
tracker/dmlc_tracker/local.py:26-49 + tracker.py:288-301):

    CRASH=1 python -m dmlc_tpu_torch.examples.distributed_pod

Worker 1's first life joins the tracker, heartbeats, and dies hard before
it joins the process group. The tracker OBSERVES the death (missed
heartbeats), the launcher relaunches the worker with the same
``DMLC_TASK_ID`` (``DMLC_NUM_ATTEMPT`` contract), and the second life
rabit-``recover``s its prior rank, joins the group, and the job completes
normally.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

NUM_COL = 8
ROWS = 2048



def _say(line: str) -> None:
    """One line of a rank's output in one write: the ranks share their
    parent's stdout, and ``print`` writes the text and its newline apart,
    so two ranks' lines could run together on an unbuffered stream."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()

def make_corpus(path: str) -> None:
    import numpy as np

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=NUM_COL)
    with open(path, "w") as f:
        for _ in range(ROWS):
            x = rng.normal(size=NUM_COL)
            y = int(x @ w_true > 0)
            feats = " ".join(f"{j}:{x[j]:.5f}" for j in range(NUM_COL))
            f.write(f"{y} {feats}\n")


def pick_backend(device, world: int):
    """The group's backend: the library's choice (NCCL on the card, gloo
    on the CPU), except that ranks sharing a card name gloo."""
    import torch

    if device is None and torch.cuda.device_count() < world:
        return "gloo"
    return None


def worker(device) -> None:
    import time

    from dmlc_tpu_torch.parallel.distributed import exit_rank, init_from_env, pod_identity
    from dmlc_tpu_torch.tracker.client import WorkerClient

    task_id = int(os.environ["DMLC_TASK_ID"])
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    # rabit plane: rank-stable rendezvous, liveness heartbeats, and
    # job-completion bookkeeping (the tracker waits for every rank's
    # shutdown). The rabit rendezvous runs BEFORE the process group so a
    # crashing first life never blocks the group's rendezvous.
    client = WorkerClient(os.environ["DMLC_TRACKER_URI"],
                          int(os.environ["DMLC_TRACKER_PORT"]))
    rank_file = os.environ["DATA"] + f".rank{task_id}"
    if os.environ.get("CRASH") == "1" and task_id == 1 and attempt == 0:
        client.start()
        with open(rank_file, "w") as f:
            f.write(str(client.rank))  # "checkpoint" the assigned rank
        client.start_heartbeat(0.2)
        time.sleep(0.6)
        _say(f"[worker {task_id}] simulating mid-job crash")
        os._exit(17)  # hard death: heartbeats stop, no shutdown sent
    if attempt > 0 and os.path.exists(rank_file):
        # a relaunched worker whose previous life checkpointed a rank
        # rejoins rank-stable; other relaunches (transient failures with no
        # checkpoint) just start fresh
        time.sleep(1.6)  # stay silent past the liveness window: the
        #                  tracker must OBSERVE the death, not just a retry
        with open(rank_file) as f:
            old_rank = int(f.read())
        client.recover(old_rank)  # rank-stable rejoin
        _say(f"[worker {task_id}] recovered rabit rank {old_rank} (attempt {attempt})")
    else:
        client.start()
    # beat well inside the liveness window (1.0s in the demo): an interval
    # equal to the timeout would flag healthy-but-jittery ranks as lost.
    # metrics=True makes each beat carry this worker's telemetry snapshot,
    # so the tracker logs the merged per-rank × per-stage ingest table
    client.start_heartbeat(0.25, metrics=True)

    world = int(os.environ["DMLC_NUM_WORKER"])
    init_from_env(device=device, backend=pick_backend(device, world))
    # resolve rank/world through pod_identity — the SAME env contract
    # (DMLC_TASK_ID/DMLC_NUM_WORKER first, the process group as fallback)
    # that parallel/distributed.py and pod_sharding= use, so the example
    # and the library can never disagree about which shard a host owns
    rank, world = pod_identity()
    import torch.distributed as dist

    _say(f"[worker {rank}/{world}] {dist.get_backend()} group up")

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.parallel import make_mesh, sync_min

    mesh = make_mesh(devices=device)
    model = LinearLearner(num_col=NUM_COL, objective="logistic",
                          learning_rate=0.5, mesh=mesh)
    # shard index = task id: each worker reads only its byte range
    batch = 64
    probe = create_parser(os.environ["DATA"], rank, world, "libsvm",
                          threaded=False)
    local_rows = sum(len(b) for b in probe)
    probe.close()
    # SPMD safety: byte-range shards rarely hold EQUAL batch counts, and a
    # rank running one extra collective step waits forever — agree on
    # min(local_steps) before training (dmlc_tpu_torch.parallel.sync_min)
    steps = sync_min(local_rows // batch)
    parser = create_parser(os.environ["DATA"], rank, world, "libsvm")
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=batch,
                    layout="dense", mesh=mesh, shardings=model.batch_shardings(),
                    drop_remainder=True)
    model.fit(it, epochs=5, steps_per_epoch=steps)
    acc = model.accuracy(it, max_steps=steps)
    it.close()
    _say(f"[worker {rank}/{world}] accuracy {float(acc):.3f} ({steps} steps/epoch)")
    client.stop_heartbeat()
    client.shutdown()
    exit_rank()  # destroys the group and skips torch's teardown at exit


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the device of every rank (default: the card)")
    args = ap.parse_args(argv)
    if os.environ.get("DMLC_ROLE") == "worker":
        worker(args.device)
        return
    import shutil
    import tempfile

    from dmlc_tpu_torch.tracker.submit import main as submit

    tmp = tempfile.mkdtemp()
    data = os.path.join(tmp, "pod.libsvm")
    make_corpus(data)
    os.environ["DATA"] = data
    nworker = int(os.environ.get("NWORKER", "2"))
    argv = ["--cluster", "tpu-pod", "--num-workers", str(nworker),
            "--host-ip", "127.0.0.1"]
    if os.environ.get("CRASH") == "1":
        # recovery demo: arm heartbeat failure detection + the relaunch
        # contract (see module docstring)
        os.environ["DMLC_LIVENESS_TIMEOUT"] = "1.0"
        argv += ["--local-num-attempt", "3"]
    cmd = [sys.executable, os.path.abspath(__file__)]
    if args.device is not None:
        cmd += ["--device", args.device]
    try:
        submit(argv + ["--"] + cmd)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("pod job finished")


if __name__ == "__main__":
    main()
