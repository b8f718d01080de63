"""The port's tracker on the rabit wire and its standalone CLI, against
the JAX package's (the cases of ``tests/test_tracker_wire.py``).

- ``tests/data/rabit_rendezvous_v1.json``, the recorded two-worker
  rendezvous, replays byte for byte against the port's
  :class:`~dmlc_tpu_torch.tracker.RabitTracker` with plain struct-packed
  sockets (the JAX test's replay harness, no client of either package);
- ``python -m dmlc_tpu_torch.tracker.tracker --num-workers N`` prints the
  JAX CLI's ``DMLC_TRACKER_ENV_START``/``END`` block (the same keys, in the
  same order, the same values but the port); a worker of either package
  rendezvouses against it from the parsed env and the process exits 0;
- the parameter-server mode is refused with JAX's message.
"""

import os
import subprocess
import sys
import threading

import pytest

from test_tracker_wire import FIXTURE, _read_env_block, _TranscriptWorker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rabit_rendezvous_transcript_replays_with_plain_sockets():
    import json

    from dmlc_tpu_torch.tracker.tracker import RabitTracker

    with open(FIXTURE, encoding="utf-8") as f:
        fixture = json.load(f)
    assert fixture["version"] == 1
    tracker = RabitTracker("127.0.0.1", 2, port=25000)
    tracker.start(2)
    addr = ("127.0.0.1", tracker.port)
    first, second = fixture["order"]
    wa = _TranscriptWorker(first, fixture["workers"][first], addr)
    wb = _TranscriptWorker(second, fixture["workers"][second], addr)
    try:
        sock_a = wa.connect_and_hello()
        sock_b = wb.connect_and_hello()
        ta = threading.Thread(target=wa.broker, args=(sock_a,))
        tb = threading.Thread(target=wb.broker, args=(sock_b,))
        ta.start()
        tb.start()
        ta.join(timeout=20)
        tb.join(timeout=20)
        assert not ta.is_alive() and not tb.is_alive(), "brokering hung"
        assert not wa.errors, wa.errors
        assert not wb.errors, wb.errors
        assert wb.captured["$HOST_A"] == "127.0.0.1"
        assert wb.captured["$PORT_A"] == wa.listen_port
        assert len(wa.peer_socks) == 1 and len(wb.peer_socks) == 1
        wa.shutdown()
        wb.shutdown()
        tracker.join(timeout=10)
        assert not tracker.alive()
    finally:
        wa.close()
        wb.close()
        tracker.close()


def _cli(package: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", f"{package}.tracker.tracker", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)
    proc.stdout.close()
    proc.stderr.close()


@pytest.mark.parametrize("client", ["torch", "jax"])
def test_tracker_cli_env_block_and_rendezvous(client):
    """The port's CLI prints the env block; a worker started from it
    rendezvouses and shuts down, and the tracker process exits 0."""
    if client == "torch":
        from dmlc_tpu_torch.tracker.client import WorkerClient
    else:
        from dmlc_tpu.tracker.client import WorkerClient

    proc = _cli("dmlc_tpu_torch", "--num-workers", "1", "--host-ip", "127.0.0.1")
    try:
        envs = _read_env_block(proc.stdout)
        assert envs["DMLC_NUM_WORKER"] == "1" and envs["DMLC_NUM_SERVER"] == "0"
        assert envs["DMLC_TRACKER_URI"] == "127.0.0.1"
        worker = WorkerClient(envs["DMLC_TRACKER_URI"], int(envs["DMLC_TRACKER_PORT"]))
        assignment = worker.start(world_size=1)
        assert (assignment.rank, assignment.world_size) == (0, 1)
        worker.shutdown()
        assert proc.wait(timeout=20) == 0
    finally:
        _stop(proc)


@pytest.mark.parametrize("num_workers", [1, 3])
def test_tracker_cli_env_block_equals_jax(num_workers):
    """The two CLIs' env blocks: the same lines in the same order, the
    port aside (each tracker binds the first free one)."""
    blocks = {}
    for package in ("dmlc_tpu_torch", "dmlc_tpu"):
        proc = _cli(package, "--num-workers", str(num_workers), "--host-ip", "127.0.0.1")
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if line.strip() == "DMLC_TRACKER_ENV_END":
                    break
            blocks[package] = [ln for ln in lines if not ln.startswith("DMLC_TRACKER_PORT=")]
            assert any(ln.startswith("DMLC_TRACKER_PORT=") for ln in lines)
        finally:
            _stop(proc)
    assert blocks["dmlc_tpu_torch"] == blocks["dmlc_tpu"]
    assert blocks["dmlc_tpu_torch"][0] == "DMLC_TRACKER_ENV_START"
    assert f"DMLC_NUM_WORKER={num_workers}" in blocks["dmlc_tpu_torch"]


def test_tracker_cli_rejects_ps_mode():
    out = {}
    for package in ("dmlc_tpu_torch", "dmlc_tpu"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{package}.tracker.tracker", "--num-workers", "1",
             "--num-servers", "1", "--host-ip", "127.0.0.1"],
            capture_output=True, text=True, timeout=60, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode != 0
        out[package] = proc.stderr.strip().splitlines()[-1]
    assert "standalone" in out["dmlc_tpu_torch"]
    assert out["dmlc_tpu_torch"] == out["dmlc_tpu"]
