"""The fake cloud's servers take a burst of connections (fault C15).

``dmlc_tpu_torch/testing/fake_cloud.py`` serves each protocol on an
``http.server``; the standard library's keep ``socketserver``'s listen
backlog of 5, and a burst of connections past it overflows the accept
queue, where a client can wait out its whole attempt timeout (60 s in the
port's ``RetryPolicy``) before a retry heals it. These pin the repair:

- every server of the fake, in process and as a child process (the
  control server too), listens with a backlog of at least 128, and counts
  the connections it accepted and served;
- 64 concurrent Range GETs against one server (opened together behind a
  barrier) all finish within a few seconds, hardly any past the 1 s of a
  SYN's first retransmit, each accepted and served once (on a backlog of
  5, most of them take over 1 s and now and then one waits 30 s).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from dmlc_tpu_torch.testing.fake_cloud import BACKLOG, PROTOCOLS, FakeCloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BURST = 64
BURST_LIMIT_S = 5.0


def _burst(url: str, n: int = BURST) -> list:
    """``n`` Range GETs opened at once: each one's (seconds, bytes)."""
    barrier = threading.Barrier(n)

    def one(_):
        barrier.wait()
        t0 = time.monotonic()
        req = urllib.request.Request(url, headers={"Range": "bytes=0-1023"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            size = len(resp.read())
        return time.monotonic() - t0, size

    with ThreadPoolExecutor(n) as ex:
        return list(ex.map(one, range(n)))


def test_every_server_listens_on_a_deep_backlog():
    assert BACKLOG >= 128
    with FakeCloud() as fake:
        conns = fake.connections()
        assert sorted(conns) == sorted(PROTOCOLS)
        assert all(c["backlog"] >= 128 for c in conns.values())
        assert all(s.request_queue_size >= 128 for s in fake._servers.values())
        assert fake.stats()["connections"] == conns


def test_child_process_servers_and_control_listen_on_a_deep_backlog():
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "dmlc_tpu_torch", "testing",
                                                          "fake_cloud.py")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        with urllib.request.urlopen(info["control"] + "/stats", timeout=30) as resp:
            conns = json.loads(resp.read())["connections"]
        assert sorted(conns) == sorted(PROTOCOLS + ("control",))
        assert all(c["backlog"] >= 128 for c in conns.values())
        assert conns["control"]["accepted"] == 1  # this stats call
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("proto", ["http", "hdfs"])
def test_a_burst_of_64_range_gets_finishes_in_seconds(proto):
    with FakeCloud() as fake:
        fake.put(proto, "/burst.bin", bytes(range(256)) * 16)
        path = ("/burst.bin" if proto == "http"
                else "/webhdfs/v1/burst.bin?op=OPEN&offset=0&length=1024")
        before = fake.connections()[proto]
        t0 = time.monotonic()
        got = _burst(fake.url(proto) + path)
        wall = time.monotonic() - t0
        after = fake.connections()[proto]
    secs = [t for t, _ in got]
    assert all(size == 1024 for _, size in got)
    assert max(secs) < BURST_LIMIT_S and wall < 2 * BURST_LIMIT_S, (max(secs), wall)
    # an overflowed accept queue delays a connection by the SYN's first
    # retransmit (1 s): on a backlog of 5 most of the 64 take over 1 s
    assert sum(t > 1.0 for t in secs) <= BURST // 16, sorted(secs)[-8:]
    # WebHDFS answers OPEN with a redirect: two connections a read
    per_read = 1 if proto == "http" else 2
    assert after["accepted"] - before["accepted"] == per_read * BURST
    assert after["served"] - before["served"] == per_read * BURST
