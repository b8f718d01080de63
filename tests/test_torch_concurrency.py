"""The port's concurrency toolkit and checkpoint cases against the JAX
package's (``tests/test_concurrency.py``'s cases, each through both).

- ``ConcurrentBlockingQueue``: FIFO, priority with FIFO among equal
  priorities, the kill signal and ``resume``, a cross-thread hand-off;
- ``ThreadGroup``: a thread's exception re-raised by ``join``, a running
  name refused and a finished one taken again, the cooperative shutdown,
  ``timer_thread`` and ``blocking_queue_thread``, the group's exit waking
  a worker parked in ``pop``;
- checkpoints: a parser (bare and threaded), a ``LineSplitter``, a
  ``DeviceIter(dense, device="cpu")``, an ``IndexedRecordIOSplitter``
  (sequential and shuffled) and a split stopped at a file join resume
  where they stopped, the rows equal to the JAX package's;
- ``OrderedWorkerPool``: order under uneven work, the terminal end, an
  item's and the source's exceptions in order, the bound on pulled items,
  ``destroy``.
"""

import json
import threading
import time

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.io import input_split as jax_split
from dmlc_tpu.io import recordio as jax_rio
from dmlc_tpu.io.filesystem import get_filesystem as jax_get_filesystem
from dmlc_tpu.io.threaded_iter import OrderedWorkerPool as JaxPool
from dmlc_tpu.utils import concurrency as jax_conc
from dmlc_tpu.utils import thread_group as jax_tg
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.io import input_split as port_split
from dmlc_tpu_torch.io import recordio as port_rio
from dmlc_tpu_torch.io.filesystem import get_filesystem
from dmlc_tpu_torch.io.threaded_iter import OrderedWorkerPool
from dmlc_tpu_torch.utils import concurrency as port_conc
from dmlc_tpu_torch.utils import thread_group as port_tg
from dmlc_tpu_torch.utils.check import DMLCError

PKGS = {"port": (port_conc, port_tg, DMLCError), "jax": (jax_conc, jax_tg, JaxDMLCError)}
BOTH = pytest.mark.parametrize("pkg", list(PKGS))


# ---------------- ConcurrentBlockingQueue ----------------

def _fifo(pkg):
    q = PKGS[pkg][0].ConcurrentBlockingQueue()
    for i in range(5):
        q.push(i)
    return [q.pop() for _ in range(5)] + [q.size(), q.try_pop()]


def _priority(pkg):
    Q = PKGS[pkg][0].ConcurrentBlockingQueue
    q = Q(Q.PRIORITY)
    for item, prio in (("low", 1), ("high", 9), ("mid", 5), ("high2", 9)):
        q.push(item, priority=prio)
    return [q.pop() for _ in range(4)]


def test_fifo_order():
    assert _fifo("port") == _fifo("jax") == [0, 1, 2, 3, 4, 0, None]


def test_priority_order():
    assert _priority("port") == _priority("jax") == ["high", "high2", "mid", "low"]
    for pkg in PKGS:
        with pytest.raises(ValueError, match="unknown queue kind"):
            PKGS[pkg][0].ConcurrentBlockingQueue("lifo")
    assert port_conc.Spinlock is jax_conc.Spinlock is threading.Lock


@BOTH
def test_signal_for_kill_wakes_blocked_pop(pkg):
    q = PKGS[pkg][0].ConcurrentBlockingQueue()
    got = []
    t = threading.Thread(target=lambda: got.append(q.pop()))
    t.start()
    time.sleep(0.05)
    q.signal_for_kill()
    t.join(2)
    assert not t.is_alive() and got == [None]
    q.push(7)
    assert q.pop(timeout=0.1) is None and q.try_pop() is None  # killed until resume
    q.resume()
    assert q.pop() == 7


@BOTH
def test_cross_thread_handoff(pkg):
    q = PKGS[pkg][0].ConcurrentBlockingQueue()
    n, out = 500, []

    def producer():
        for i in range(n):
            q.push(i)

    ts = [threading.Thread(target=producer),
          threading.Thread(target=lambda: [out.append(q.pop()) for _ in range(n)])]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert out == list(range(n))


# ---------------- ThreadGroup ----------------

@BOTH
def test_create_join_and_exception_rethrow(pkg):
    g = PKGS[pkg][1].ThreadGroup()

    def boom(token):
        raise ValueError("producer exploded")

    t = g.create("boom", boom)
    with pytest.raises(ValueError, match="exploded"):
        t.join(2)
    t.join(2)  # the exception is raised once
    g.create("boom2", boom)
    with pytest.raises(ValueError, match="exploded"):
        g.join_all(2)


def _duplicate_case(pkg):
    conc, tg, err = PKGS[pkg]
    g = tg.ThreadGroup()
    release = threading.Event()
    g.create("w", lambda token: release.wait(5))
    with pytest.raises(err) as exc:
        g.create("w", lambda token: None)
    release.set()
    g.join_all(2)
    again = g.create("w", lambda token: None)  # a finished name is taken again
    again.join(2)
    with pytest.raises(err) as timer_exc:
        tg.timer_thread(g, "t", 0, lambda: None)
    return [str(exc.value), g.get("w") is again, str(timer_exc.value)]


def test_duplicate_running_name_rejected():
    assert _duplicate_case("port") == _duplicate_case("jax")


@BOTH
def test_shutdown_all_stops_cooperative_threads(pkg):
    g = PKGS[pkg][1].ThreadGroup()
    ticks = []
    t = g.create("loop", lambda token: [ticks.append(1) or token.wait(0.01)
                                        for _ in iter(lambda: token.stopped, True)])
    time.sleep(0.05)
    assert t.joinable
    g.request_shutdown_all()
    g.join_all(2)
    assert ticks and not t.joinable


@BOTH
def test_timer_thread_fires_periodically(pkg):
    tg = PKGS[pkg][1]
    g = tg.ThreadGroup()
    fired = []
    t = tg.timer_thread(g, "tick", 0.02, lambda: fired.append(time.monotonic()),
                        run_first_immediately=True)
    time.sleep(0.15)
    t.request_shutdown()
    t.join(2)
    assert len(fired) >= 3 and not t.joinable


@BOTH
def test_blocking_queue_thread_drains_until_kill(pkg):
    conc, tg, _ = PKGS[pkg]
    g = tg.ThreadGroup()
    q = conc.ConcurrentBlockingQueue()
    seen = []
    t = tg.blocking_queue_thread(g, "drain", q, seen.append)
    for i in range(10):
        q.push(i)
    time.sleep(0.1)
    t.request_shutdown()
    t.join(2)
    assert seen == list(range(10)) and not t.joinable


@BOTH
def test_group_exit_wakes_blocked_queue_worker(pkg):
    conc, tg, _ = PKGS[pkg]
    g = tg.ThreadGroup()
    q = conc.ConcurrentBlockingQueue()
    seen = []
    with g:
        blocking_worker = tg.blocking_queue_thread(g, "w", q, seen.append)
        q.push(1)
        time.sleep(0.05)
    assert seen == [1] and not blocking_worker.joinable


def test_thread_inherits_the_creators_scope():
    from dmlc_tpu_torch.utils import telemetry

    seen = []
    with telemetry.scope("pipeline-7"):
        g = port_tg.ThreadGroup()
        g.create("s", lambda token: seen.append(telemetry.current_scope()))
    g.join_all(2)
    assert seen == ["pipeline-7"]


# ---------------- checkpoints ----------------

def _corpus(tmp_path, rows=400):
    f = tmp_path / "ckpt.libsvm"
    f.write_text("\n".join(f"{i % 2} " + " ".join(f"{j}:{(i * 7 + j) % 13}.5" for j in range(6))
                           for i in range(rows)) + "\n")
    return str(f)


def _labels(blocks):
    return [float(v) for b in blocks for v in np.asarray(b.label)]


def _parser_resume(factory, uri, threaded):
    kw = dict(chunk_bytes=4096)
    full = factory(uri, 0, 1, "libsvm", threaded=threaded, **kw)
    all_blocks = _labels(list(full))
    full.close()
    p = factory(uri, 0, 1, "libsvm", threaded=threaded, **kw)
    first = _labels([p.next_block() for _ in range(2)])
    state = json.loads(json.dumps(p.state_dict()))
    p.close()
    q = factory(uri, 0, 1, "libsvm", threaded=threaded, **kw)
    q.load_state(state)
    rest = _labels(list(q))
    q.close()
    return all_blocks, first + rest


@pytest.mark.parametrize("threaded", [False, True])
def test_parser_resume_matches_uninterrupted(tmp_path, threaded):
    uri = _corpus(tmp_path)
    full, spliced = _parser_resume(create_parser, uri, threaded)
    assert spliced == full and len(full) == 400
    assert _parser_resume(jax_create_parser, uri, threaded) == (full, spliced)


def _drain(split) -> list:
    out = []
    while True:
        r = split.next_record()
        if r is None:
            return out
        out.append(bytes(r))


def test_split_byte_exact_state(tmp_path):
    uri = _corpus(tmp_path)
    s = port_split.LineSplitter(get_filesystem(uri), uri, part_index=0, num_parts=1,
                                  chunk_bytes=4096)
    j = jax_split.LineSplitter(jax_get_filesystem(uri), uri)
    j.reset_partition(0, 1)
    j.hint_chunk_size(4096)
    for split in (s, j):
        for _ in range(10):
            split.next_record()
    state, jstate = s.state_dict(), j.state_dict()
    rest = _drain(s)
    assert rest == _drain(j) and len(rest) == 390
    for split in (s, j):
        split.close()
    # each package's state resumes in the other
    s2 = port_split.LineSplitter(get_filesystem(uri), uri, part_index=0, num_parts=1,
                                  chunk_bytes=4096)
    s2.load_state(json.loads(json.dumps(jstate)))
    j2 = jax_split.LineSplitter(jax_get_filesystem(uri), uri)
    j2.reset_partition(0, 1)
    j2.hint_chunk_size(4096)
    j2.load_state(json.loads(json.dumps(state)))
    assert _drain(s2) == _drain(j2) == rest
    s2.close()
    j2.close()


def test_device_iter_resume(tmp_path):
    uri = _corpus(tmp_path)

    def run(factory, make_iter):
        it = make_iter(factory(uri, 0, 1, "libsvm", threaded=True, chunk_bytes=4096))
        full = [np.asarray(b[0]) for b in it]
        it.reset()
        consumed = [np.asarray(next(it)[0]) for _ in range(2)]
        it.load_state(it.state_dict())
        rest = [np.asarray(b[0]) for b in it]
        it.close()
        return np.concatenate(full), np.concatenate(consumed + rest)

    full, spliced = run(create_parser, lambda p: DeviceIter(p, num_col=6, batch_size=64,
                                                             layout="dense", device="cpu"))
    np.testing.assert_array_equal(spliced, full)
    jfull, jspliced = run(jax_create_parser,
                          lambda p: JaxDeviceIter(p, num_col=6, batch_size=64, layout="dense"))
    np.testing.assert_array_equal(full, jfull)
    np.testing.assert_array_equal(spliced, jspliced)


def test_indexed_recordio_checkpoint(tmp_path):
    rec, idx = tmp_path / "d.rec", tmp_path / "d.idx"
    payloads = [f"record-{i}".encode() * 3 for i in range(50)]
    with open(rec, "wb") as rf, open(idx, "w") as xf:
        port_rio.write_indexed_recordio(rf, xf, payloads)
    with open(tmp_path / "j.rec", "wb") as rf, open(tmp_path / "j.idx", "w") as xf:
        jax_rio.write_indexed_recordio(rf, xf, payloads)
    assert (tmp_path / "j.rec").read_bytes() == rec.read_bytes()
    assert (tmp_path / "j.idx").read_text() == idx.read_text()

    def port_make(seed, shuffle):
        # the JAX package's call (tests/test_concurrency.py): fs first, then
        # the partition
        s = port_split.IndexedRecordIOSplitter(get_filesystem(str(rec)), str(rec), str(idx),
                                               batch_size=4, shuffle=shuffle, seed=seed)
        s.reset_partition(0, 1)
        return s

    def jax_make(seed, shuffle):
        s = jax_split.IndexedRecordIOSplitter(jax_get_filesystem(str(rec)), str(rec), str(idx),
                                              batch_size=4, shuffle=shuffle, seed=seed)
        s.reset_partition(0, 1)
        return s

    for shuffle in (False, True):
        got = {}
        for pkg, make in (("port", port_make), ("jax", jax_make)):
            s = make(7, shuffle)
            first = [bytes(s.next_record()) for _ in range(9)]
            state = json.loads(json.dumps(s.state_dict()))
            rest_a = [bytes(r) for r in s.iter_records()]
            s.close()
            s2 = make(999, shuffle)  # another seed: the state carries the order
            s2.load_state(state)
            rest_b = [bytes(r) for r in s2.iter_records()]
            s2.close()
            assert rest_a == rest_b, (pkg, shuffle)
            assert sorted(first + rest_a) == sorted(payloads)
            got[pkg] = first + rest_a
        assert got["port"] == got["jax"], shuffle


def test_split_checkpoint_at_file_join(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_bytes(b"a1\na2-noeol")  # no trailing newline
    b.write_bytes(b"b1\nb2\n")
    uri = f"{a};{b}"

    def port_make():
        return port_split.LineSplitter(get_filesystem(uri), uri, part_index=0, num_parts=1)

    def jax_make():
        s = jax_split.LineSplitter(jax_get_filesystem(str(a)), uri)
        s.reset_partition(0, 1)
        return s

    out = {}
    for pkg, make in (("port", port_make), ("jax", jax_make)):
        s = make()
        data = s._read(a.stat().st_size)
        assert s.offset_curr == a.stat().st_size
        state = json.loads(json.dumps(s.state_dict()))
        s.close()
        s2 = make()
        s2.load_state(state)
        rest = b""
        while True:
            got = s2._read(10_000)
            if not got:
                break
            rest += got
        s2.close()
        out[pkg] = data + rest
    assert out["port"] == out["jax"]
    assert out["port"].split(b"\n") == [b"a1", b"a2-noeol", b"b1", b"b2", b""]


# ---------------- OrderedWorkerPool ----------------

POOLS = {"port": (OrderedWorkerPool, DMLCError), "jax": (JaxPool, JaxDMLCError)}


def _pool(pkg, n=20, workers=3, ahead=4, work=None):
    return POOLS[pkg][0](lambda: iter(range(n)), work or (lambda i: i * 2),
                         num_workers=workers, max_ahead=ahead)


@BOTH
def test_order_preserved_under_parallel_work(pkg):
    pool = _pool(pkg, work=lambda i: (time.sleep(0.002 * (20 - i)), i)[1])
    assert list(pool) == list(range(20))
    pool.destroy()


@BOTH
def test_end_of_stream_is_none_and_stays(pkg):
    pool = _pool(pkg, n=3, workers=2)
    assert [pool.next() for _ in range(3)] == [0, 2, 4]
    assert pool.next() is None and pool.next() is None
    pool.destroy()


@BOTH
def test_work_exception_rethrown_in_order(pkg):
    def work(i):
        if i == 5:
            raise ValueError("item five")
        return i

    pool = _pool(pkg, work=work)
    got = []
    with pytest.raises(ValueError, match="item five"):
        while True:
            item = pool.next()
            if item is None:
                break
            got.append(item)
    assert got == [0, 1, 2, 3, 4] and pool.next() is None
    pool.destroy()


@BOTH
def test_source_exception_rethrown_after_drain(pkg):
    def src():
        yield from range(3)
        raise RuntimeError("source died")

    pool = POOLS[pkg][0](src, lambda i: i, num_workers=2)
    assert [pool.next() for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="source died"):
        pool.next()
    pool.destroy()


@BOTH
def test_backpressure_bounded(pkg):
    pulled = []

    def src():
        for i in range(100):
            pulled.append(i)
            yield i

    pool = POOLS[pkg][0](src, lambda i: i, num_workers=2, max_ahead=4)
    assert pool.next() == 0
    time.sleep(0.1)
    assert len(pulled) <= 1 + 4 + 2, pulled
    pool.destroy()


@BOTH
def test_destroy_joins_and_poisons(pkg):
    pool = _pool(pkg, n=1000, work=lambda i: (time.sleep(0.001), i)[1])
    assert pool.next() == 0
    pool.destroy()
    with pytest.raises(POOLS[pkg][1]):
        pool.next()
    pool.destroy()  # idempotent
