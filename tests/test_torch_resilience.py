"""The port's fault-tolerance layer against the JAX package's, case by case.

A twin of every test in ``tests/test_resilience.py``, each run through
both packages (``ref`` the JAX package, ``port`` this one) with the same
inputs and the same fault plans, and held to the JAX test's asserts: the
classifier, ``RetryPolicy`` (backoff, jitter, ``Retry-After``, deadline),
the fault-plan grammar and its flow through the policy,
``ResilientStream``'s resume at the exact offset, the bounded producer
restarts of ``ThreadedIter`` and ``OrderedWorkerPool`` with the stall
diagnostic, HTTP streams against a local ``ThreadingHTTPServer`` (the JAX
suite's ``http_files``), and a ``DeviceIter`` epoch over HTTP under
injected plans (the port's with ``device="cpu"``). Where the two packages
have one answer (the counters, ``fired()``, the batches), the port's is
compared with the JAX package's too.

``TestLintRetryGate``: the two ``scan_source`` cases run once (the scanner
is ``bin/lint_retry.py``'s, loaded by path); ``test_repo_is_clean`` becomes
the port's gate, scanning ``dmlc_tpu_torch/**/*.py`` outside
``io/resilience.py``. The JAX test of the same name runs the script over
``dmlc_tpu/`` and stays in the JAX suite. Every other JAX test has a twin.
``COUNTERS``, the process-wide counter object, answers as the JAX one.
"""

import http.server
import importlib.util
import io as _pyio
import threading
import types
import urllib.error
from pathlib import Path

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.io import faults as jax_faults
from dmlc_tpu.io import filesystem as jax_filesystem
from dmlc_tpu.io import http_filesys as jax_http
from dmlc_tpu.io import open_stream as jax_open_stream
from dmlc_tpu.io import read_all as jax_read_all
from dmlc_tpu.io import resilience as jax_res
from dmlc_tpu.io import threaded_iter as jax_threaded
from dmlc_tpu.io.uri import URI as JaxURI
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.io import faults as port_faults
from dmlc_tpu_torch.io import filesystem as port_filesystem
from dmlc_tpu_torch.io import http_filesys as port_http
from dmlc_tpu_torch.io import open_stream as port_open_stream
from dmlc_tpu_torch.io import read_all as port_read_all
from dmlc_tpu_torch.io import resilience as port_res
from dmlc_tpu_torch.io import threaded_iter as port_threaded
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError

from test_resilience import _HttpFilesHandler, _http_error, _make_libsvm  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _port_iter(parser, **kw):
    return DeviceIter(parser, device="cpu", **kw)


PKGS = {
    "ref": types.SimpleNamespace(
        faults=jax_faults, res=jax_res, threaded=jax_threaded, http=jax_http,
        fs=jax_filesystem, URI=JaxURI, err=JaxDMLCError, open_stream=jax_open_stream,
        read_all=jax_read_all, create_parser=jax_create_parser, device_iter=JaxDeviceIter),
    "port": types.SimpleNamespace(
        faults=port_faults, res=port_res, threaded=port_threaded, http=port_http,
        fs=port_filesystem, URI=URI, err=DMLCError, open_stream=port_open_stream,
        read_all=port_read_all, create_parser=create_parser, device_iter=_port_iter),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    """Millisecond backoffs and clean counters and plans in both packages."""
    monkeypatch.setenv("DMLC_RETRY_BASE_MS", "1")
    monkeypatch.setenv("DMLC_RETRY_MAX_MS", "5")
    monkeypatch.delenv("DMLC_RETRY_MAX_ATTEMPTS", raising=False)
    monkeypatch.delenv("DMLC_FAULT_PLAN", raising=False)
    for p in PKGS.values():
        p.faults.reset()
        p.res.reset_counters()
    yield
    for p in PKGS.values():
        p.faults.reset()


@pytest.fixture()
def http_files():
    """The JAX suite's local HTTP server (``tests/test_resilience.py``)."""
    _HttpFilesHandler.files = {}
    _HttpFilesHandler.flaky_503 = 0
    _HttpFilesHandler.flaky_429 = 0
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _HttpFilesHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield _HttpFilesHandler, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


class TestClassifier:
    @pytest.mark.parametrize("code,kind", [
        (500, "retryable"), (502, "retryable"), (503, "retryable"), (504, "retryable"),
        (429, "retryable"), (408, "retryable"), (400, "fatal"), (401, "fatal"),
        (403, "fatal"), (404, "fatal"), (416, "fatal"),
    ])
    def test_http_codes(self, pkg, code, kind):
        assert pkg.res.classify(_http_error(code)) == kind

    def test_connection_and_timeout_classes(self, pkg):
        import http.client as hc
        import socket

        for exc in (ConnectionResetError(), ConnectionRefusedError(), TimeoutError(),
                    socket.timeout(), hc.IncompleteRead(b"x"),
                    urllib.error.URLError("dns broke")):
            assert pkg.res.classify(exc) == pkg.res.RETRYABLE

    def test_urlerror_realistic_reasons(self, pkg):
        import errno
        import socket
        import ssl

        R, F = pkg.res.RETRYABLE, pkg.res.FATAL
        assert pkg.res.classify(urllib.error.URLError(
            socket.gaierror(-2, "Name or service not known"))) == R
        assert pkg.res.classify(urllib.error.URLError(
            OSError(errno.EHOSTUNREACH, "No route to host"))) == R
        assert pkg.res.classify(urllib.error.URLError(
            ConnectionRefusedError(111, "refused"))) == R
        assert pkg.res.classify(urllib.error.URLError(
            ssl.SSLCertVerificationError("certificate verify failed"))) == F
        plan = pkg.faults.FaultPlan("read@1=unreachable")
        assert pkg.res.classify(plan.check("read")) == R

    def test_deterministic_errors_are_fatal(self, pkg):
        for exc in (ValueError("bad uri"), pkg.err("malformed"), FileNotFoundError("gone")):
            assert pkg.res.classify(exc) == pkg.res.FATAL

    def test_cause_chain_preserves_class(self, pkg):
        wrapped = pkg.err("read failed")
        wrapped.__cause__ = _http_error(503)
        assert pkg.res.classify(wrapped) == pkg.res.RETRYABLE
        double = pkg.err("outer")
        double.__cause__ = wrapped
        assert pkg.res.classify(double) == pkg.res.RETRYABLE
        fatal = pkg.err("auth")
        fatal.__cause__ = _http_error(403)
        assert pkg.res.classify(fatal) == pkg.res.FATAL

    def test_retry_after_header_parse(self, pkg):
        ra = pkg.res.retry_after_seconds
        assert ra(_http_error(429, {"Retry-After": "2"})) == 2.0
        assert ra(_http_error(429)) == 0.0
        assert ra(_http_error(429, {"Retry-After": "Wed, 21 Oct 2026 07:28:00 GMT"})) == 0.0
        wrapped = pkg.err("w")
        wrapped.__cause__ = _http_error(429, {"Retry-After": "0.5"})
        assert ra(wrapped) == 0.5


class TestRetryPolicy:
    def test_succeeds_after_transient_failures(self, pkg):
        pol = pkg.res.RetryPolicy(max_attempts=4, base_delay=0.001, seed=7)
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionResetError("flake")
            return "ok"

        assert pol.call(fn, op="t", what="w") == "ok"
        assert calls["n"] == 3
        snap = pkg.res.counters_snapshot()
        assert snap["retries"] == 2 and snap["giveups"] == 0 and snap["attempts"] == 3

    def test_fatal_fails_in_one_attempt(self, pkg):
        pol = pkg.res.RetryPolicy(max_attempts=5, base_delay=0.001)
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            raise _http_error(403)

        with pytest.raises(pkg.err, match="non-retryable"):
            pol.call(fn, op="t", what="w")
        assert calls["n"] == 1
        snap = pkg.res.counters_snapshot()
        assert snap["fatal"] == 1 and snap["retries"] == 0

    def test_budget_exhausted_wraps_with_cause(self, pkg):
        pol = pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001)

        def fn():
            raise TimeoutError("always")

        with pytest.raises(pkg.err, match="budget exhausted") as ei:
            pol.call(fn, op="read", what="u")
        assert isinstance(ei.value.__cause__, TimeoutError)
        assert pkg.res.classify(ei.value) == pkg.res.RETRYABLE
        assert pkg.res.counters_snapshot()["giveups"] == 1

    def test_backoff_jitter_bounds_and_floor(self, pkg):
        pol = pkg.res.RetryPolicy(base_delay=0.1, max_delay=1.0, seed=42)
        for i in range(6):
            assert 0.0 <= pol.backoff(i) <= min(1.0, 0.1 * 2 ** i)
        assert pol.backoff(0, floor=0.5) >= 0.5
        assert pol.backoff(0, floor=86400.0) <= 30.0

    def test_backoff_draws_equal_the_reference(self):
        ref = jax_res.RetryPolicy(base_delay=0.1, max_delay=1.0, seed=42)
        port = port_res.RetryPolicy(base_delay=0.1, max_delay=1.0, seed=42)
        assert [port.backoff(i) for i in range(8)] == [ref.backoff(i) for i in range(8)]

    def test_retry_after_is_backoff_floor(self, pkg):
        sleeps = []
        pol = pkg.res.RetryPolicy(max_attempts=2, base_delay=0.0001, seed=0,
                                  sleep_fn=sleeps.append)
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] == 1:
                raise _http_error(429, {"Retry-After": "0.25"})
            return "ok"

        assert pol.call(fn, op="t") == "ok"
        assert sleeps and sleeps[0] >= 0.25

    def test_deadline_gives_up(self, pkg):
        pol = pkg.res.RetryPolicy(max_attempts=50, base_delay=1.0, max_delay=1.0,
                                  deadline=0.01, sleep_fn=lambda s: None)

        def fn():
            raise ConnectionResetError("x")

        with pytest.raises(pkg.err, match="deadline exceeded"):
            pol.call(fn, op="t")

    def test_resume_offset_counts_resumes(self, pkg):
        pol = pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001)
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] == 1:
                raise ConnectionResetError("mid")
            return b"data"

        pol.call(fn, op="read", what="u", resume_offset=4096)
        snap = pkg.res.counters_snapshot()
        assert snap["retries"] == 1 and snap["resumes"] == 1

    def test_from_env_knobs(self, pkg, monkeypatch):
        monkeypatch.setenv("DMLC_RETRY_MAX_ATTEMPTS", "7")
        monkeypatch.setenv("DMLC_RETRY_BASE_MS", "10")
        monkeypatch.setenv("DMLC_RETRY_MAX_MS", "200")
        monkeypatch.setenv("DMLC_RETRY_DEADLINE_S", "9")
        monkeypatch.setenv("DMLC_RETRY_ATTEMPT_TIMEOUT_S", "33")
        pol = pkg.res.RetryPolicy.from_env()
        assert pol.max_attempts == 7
        assert pol.base_delay == pytest.approx(0.01)
        assert pol.max_delay == pytest.approx(0.2)
        assert pol.deadline == pytest.approx(9.0)
        assert pol.attempt_timeout == pytest.approx(33.0)


class TestFaultPlan:
    def test_grammar_single_range_openended(self, pkg):
        plan = pkg.faults.FaultPlan("read@2;open@1..3=reset;connect@5+=timeout")
        assert plan.check("read") is None
        exc = plan.check("read")
        assert isinstance(exc, urllib.error.HTTPError) and exc.code == 503
        assert plan.check("read") is None
        for _ in range(3):
            assert isinstance(plan.check("open"), ConnectionResetError)
        assert plan.check("open") is None
        for _ in range(4):
            assert plan.check("connect") is None
        for _ in range(10):
            assert isinstance(plan.check("connect"), TimeoutError)
        assert plan.fired() == 1 + 3 + 10

    def test_substring_filter(self, pkg):
        plan = pkg.faults.FaultPlan("read~part-1@1=reset")
        assert plan.check("read", "http://h/part-0") is None
        assert isinstance(plan.check("read", "http://h/part-1"), ConnectionResetError)

    def test_error_classes(self, pkg):
        plan = pkg.faults.FaultPlan("a@1=http-429;b@1=unreachable")
        exc = plan.check("a", "u")
        assert isinstance(exc, urllib.error.HTTPError) and exc.code == 429
        assert isinstance(plan.check("b"), urllib.error.URLError)

    def test_bad_clause_rejected(self, pkg):
        with pytest.raises(pkg.err, match="bad clause"):
            pkg.faults.FaultPlan("read@@2")
        with pytest.raises(pkg.err, match="unknown error class"):
            pkg.faults.FaultPlan("read@1=kaboom")

    def test_inject_context_and_nesting(self, pkg):
        f = pkg.faults
        assert f.active_plan() is None
        with f.inject("read@1=reset") as outer:
            assert f.active_plan() is outer
            with f.inject("open@1=timeout") as inner:
                assert f.active_plan() is inner
            assert f.active_plan() is outer
        assert f.active_plan() is None

    def test_env_hook(self, pkg, monkeypatch):
        monkeypatch.setenv("DMLC_FAULT_PLAN", "read@1=reset")
        with pytest.raises(ConnectionResetError):
            pkg.faults.maybe_fail("read", "x")
        pkg.faults.maybe_fail("read", "x")
        monkeypatch.setenv("DMLC_FAULT_PLAN", "open@1=timeout")
        with pytest.raises(TimeoutError):
            pkg.faults.maybe_fail("open", "y")

    def test_injected_faults_flow_through_policy(self, pkg):
        pol = pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001)
        with pkg.faults.inject("read@1..2=http-503") as plan:
            out = pol.call(lambda: "ok", op="read", what="u")
        assert out == "ok" and plan.fired() == 2
        snap = pkg.res.counters_snapshot()
        assert snap["retries"] == 2 and snap["attempts"] == 3


class TestResilientStream:
    @staticmethod
    def _flaky_open(data, state):
        opens = []

        def open_fn():
            bio = _pyio.BytesIO(data)
            opens.append(bio)
            orig = bio.read

            def read(n=-1):
                if state.get("fails", 0) > 0 and bio.tell() >= state["at"]:
                    state["fails"] -= 1
                    raise ConnectionResetError("mid-read flake")
                return orig(n)

            bio.read = read
            return bio

        return open_fn, opens

    def test_mid_read_resume_exact_offset(self, pkg):
        data = bytes(range(256)) * 64
        open_fn, opens = self._flaky_open(data, {"fails": 1, "at": 6000})
        rs = pkg.res.ResilientStream(
            open_fn, policy=pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001),
            what="mem://flaky")
        out = bytearray()
        while True:
            chunk = rs.read(4096)
            if not chunk:
                break
            out += chunk
        assert bytes(out) == data
        assert rs.reopens == 1 and len(opens) == 2
        assert pkg.res.counters_snapshot()["resumes"] == 1

    def test_injected_read_fault_resumes_at_the_exact_offset(self, pkg):
        """The plan's ``read`` fault on the third read of a stream: the
        reopened stream resumes at the byte the fault broke, and both
        packages count the same events."""
        data = bytes(range(256)) * 64
        rs = pkg.res.ResilientStream(
            lambda: _pyio.BytesIO(data),
            policy=pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001), what="mem://plan")
        out = bytearray()
        with pkg.faults.inject("read~mem://plan@3=reset") as plan:
            while True:
                chunk = rs.read(1000)
                if not chunk:
                    break
                out += chunk
        assert bytes(out) == data and plan.fired() == 1
        snap = pkg.res.counters_snapshot()
        assert (snap["retries"], snap["resumes"], snap["giveups"]) == (1, 1, 0)

    def test_seek_then_resume(self, pkg):
        data = b"0123456789" * 2000
        open_fn, _ = self._flaky_open(data, {"fails": 1, "at": 0})
        rs = pkg.res.ResilientStream(
            open_fn, policy=pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001))
        rs.seek(12345)
        assert rs.read(10) == data[12345:12355]
        assert rs.tell() == 12355

    def test_fatal_open_propagates_once(self, pkg):
        calls = {"n": 0}

        def open_fn():
            calls["n"] += 1
            raise ValueError("malformed")

        rs = pkg.res.ResilientStream(
            open_fn, policy=pkg.res.RetryPolicy(max_attempts=5, base_delay=0.001))
        with pytest.raises(pkg.err, match="non-retryable"):
            rs.read(10)
        assert calls["n"] == 1

    def test_budget_exhausted(self, pkg):
        def open_fn():
            raise ConnectionResetError("always down")

        rs = pkg.res.ResilientStream(
            open_fn, policy=pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001))
        with pytest.raises(pkg.err, match="budget exhausted"):
            rs.read(10)

    def test_open_stream_resilient_flag(self, pkg, tmp_path):
        path = tmp_path / "f.bin"
        payload = b"resilient local bytes" * 100
        path.write_bytes(payload)
        with pkg.open_stream(str(path), "r", resilient=True) as f:
            assert isinstance(f.raw, pkg.res.ResilientStream)
            assert f.read() == payload

    def test_open_stream_resilient_noop_for_native_fs(self, pkg, http_files):
        handler, base = http_files
        handler.files["/n.bin"] = b"native resume"
        with pkg.open_stream(f"{base}/n.bin", "r", resilient=True) as f:
            assert not isinstance(f.raw, pkg.res.ResilientStream)
            assert f.read() == b"native resume"


class TestThreadedIterRestart:
    @staticmethod
    def _flaky_factory(fail_at, n_failures, n_items=10, exc=ConnectionResetError):
        state = {"fails": n_failures}

        def factory():
            def gen():
                for i in range(n_items):
                    if i == fail_at and state["fails"] > 0:
                        state["fails"] -= 1
                        raise exc("producer flake")
                    yield i
            return gen()

        return factory

    def test_restart_preserves_order_and_counts(self, pkg):
        it = pkg.threaded.ThreadedIter.from_factory(
            self._flaky_factory(4, 1),
            restart_policy=pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001))
        assert list(it) == list(range(10))
        assert it.restarts == 1 and it.restart_giveups == 0
        assert pkg.res.counters_snapshot()["producer_restarts"] == 1
        it.destroy()

    def test_budget_exhausted_rethrows(self, pkg):
        it = pkg.threaded.ThreadedIter.from_factory(
            self._flaky_factory(2, 99),
            restart_policy=pkg.res.RetryPolicy(max_attempts=2, base_delay=0.001))
        with pytest.raises(ConnectionResetError):
            list(it)
        assert it.restarts == 1 and it.restart_giveups == 1
        it.destroy()

    def test_fatal_not_restarted(self, pkg):
        it = pkg.threaded.ThreadedIter.from_factory(
            self._flaky_factory(2, 1, exc=ValueError),
            restart_policy=pkg.res.RetryPolicy(max_attempts=4, base_delay=0.001))
        with pytest.raises(ValueError):
            list(it)
        assert it.restarts == 0
        it.destroy()

    def test_disabled_by_default(self, pkg):
        it = pkg.threaded.ThreadedIter.from_factory(self._flaky_factory(2, 1))
        with pytest.raises(ConnectionResetError):
            list(it)
        assert it.restarts == 0
        it.destroy()

    def test_epoch_reset_refreshes_budget(self, pkg):
        it = pkg.threaded.ThreadedIter.from_factory(
            self._flaky_factory(3, 1),
            restart_policy=pkg.res.RetryPolicy(max_attempts=2, base_delay=0.001))
        assert list(it) == list(range(10))
        it.before_first()
        assert list(it) == list(range(10))
        assert it.restarts == 1
        it.destroy()

    def test_stall_diagnostic_reports_error_and_budget(self, pkg, monkeypatch):
        monkeypatch.setenv("DMLC_PIPELINE_STALL_TIMEOUT", "0.3")
        gate = threading.Event()

        def produce(cell):
            gate.wait(30)
            return False, None

        it = pkg.threaded.ThreadedIter(produce,
                                       restart_policy=pkg.res.RetryPolicy(max_attempts=4))
        with pytest.raises(pkg.err) as ei:
            it.next()
        msg = str(ei.value)
        assert "last producer error: none" in msg
        assert "producer restarts 0/3 used" in msg
        gate.set()
        it.destroy()


class TestOrderedWorkerPoolRestart:
    @staticmethod
    def _flaky_source(fail_at, n_failures, n_items=24):
        state = {"fails": n_failures}

        def factory():
            def gen():
                for i in range(n_items):
                    if i == fail_at and state["fails"] > 0:
                        state["fails"] -= 1
                        raise TimeoutError("source flake")
                    yield i
            return gen()

        return factory

    def test_ordering_preserved_across_midstream_restart(self, pkg):
        pool = pkg.threaded.OrderedWorkerPool(
            self._flaky_source(9, 1), lambda x: x * x, num_workers=3,
            restart_policy=pkg.res.RetryPolicy(max_attempts=3, base_delay=0.001))
        assert list(pool) == [i * i for i in range(24)]
        assert pool.restarts == 1
        pool.destroy()

    def test_giveup_rethrows_on_consumer(self, pkg):
        pool = pkg.threaded.OrderedWorkerPool(
            self._flaky_source(3, 99), lambda x: x, num_workers=2,
            restart_policy=pkg.res.RetryPolicy(max_attempts=2, base_delay=0.001))
        out = []
        with pytest.raises(TimeoutError):
            for v in pool:
                out.append(v)
        assert out == [0, 1, 2]
        assert pool.restarts == 1 and pool.restart_giveups == 1
        pool.destroy()

    def test_disabled_by_default(self, pkg):
        pool = pkg.threaded.OrderedWorkerPool(self._flaky_source(3, 1), lambda x: x)
        with pytest.raises(TimeoutError):
            list(pool)
        assert pool.restarts == 0
        pool.destroy()


def _lint_retry():
    spec = importlib.util.spec_from_file_location("lint_retry", REPO / "bin" / "lint_retry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestLintRetryGate:
    def test_flags_ad_hoc_retry_sleep(self):
        bad = ("import time\n"
               "def fetch():\n"
               "    for attempt in range(3):\n"
               "        try:\n"
               "            return do()\n"
               "        except OSError:\n"
               "            pass\n"
               "        time.sleep(0.1 * attempt)\n")
        assert _lint_retry().scan_source(bad)

    def test_ignores_non_retry_sleep(self):
        ok = ("import time\n"
              "def poll():\n"
              "    for tick in range(3):\n"
              "        time.sleep(1.0)  # fixed-rate heartbeat\n")
        assert _lint_retry().scan_source(ok) == []

    def test_repo_is_clean(self):
        """The port's gate: no retry-shaped sleep in ``dmlc_tpu_torch/``
        outside ``io/resilience.py``, the one sanctioned backoff."""
        scan = _lint_retry().scan_source
        pkg_dir = REPO / "dmlc_tpu_torch"
        allowed = pkg_dir / "io" / "resilience.py"
        offenders = [f"{p.relative_to(REPO)}:{line}: {why}"
                     for p in sorted(pkg_dir.rglob("*.py")) if p != allowed
                     for line, why in scan(p.read_text())]
        assert not offenders, "\n".join(offenders)


class TestHttpStreamResilience:
    def test_server_503s_then_succeed(self, pkg, http_files):
        handler, base = http_files
        payload = bytes(range(256)) * 200
        handler.files["/data.bin"] = payload
        handler.flaky_503 = 2
        assert pkg.read_all(f"{base}/data.bin") == payload
        snap = pkg.res.counters_snapshot()
        assert snap["retries"] == 2 and snap["giveups"] == 0

    def test_429_retry_after_honored(self, pkg, http_files):
        handler, base = http_files
        handler.files["/t.bin"] = b"throttled payload"
        handler.flaky_429 = 1
        assert pkg.read_all(f"{base}/t.bin") == b"throttled payload"
        assert pkg.res.counters_snapshot()["retries"] == 1

    def test_midread_resume_exact_byte_offset(self, pkg, http_files, monkeypatch):
        monkeypatch.setattr(pkg.http, "_BLOCK", 4096)
        handler, base = http_files
        payload = bytes(range(256)) * 128
        handler.files["/big.bin"] = payload
        fs = pkg.fs.get_filesystem(f"{base}/big.bin")
        with fs.open(pkg.URI(f"{base}/big.bin"), "r") as f:
            assert f.read(100) == payload[:100]
            f.seek(20000)
            with pkg.faults.inject("read@1=reset") as plan:
                assert f.read(128) == payload[20000:20128]
            assert plan.fired() == 1
        snap = pkg.res.counters_snapshot()
        assert snap["resumes"] >= 1
        assert (snap["retries"], snap["resumes"], snap["giveups"]) == (1, 1, 0)

    def test_fatal_403_fails_fast(self, pkg, http_files):
        handler, base = http_files
        handler.files["/secret.bin"] = b"x"
        with pkg.faults.inject("open@1=http-403") as plan:
            with pytest.raises(pkg.err, match="non-retryable"):
                pkg.read_all(f"{base}/secret.bin")
        assert plan.fired() == 1
        snap = pkg.res.counters_snapshot()
        assert snap["fatal"] == 1 and snap["retries"] == 0


def _collect_epoch(p, url, num_col=4, batch_size=64):
    parser = p.create_parser(url, 0, 1, "libsvm", chunk_bytes=2048)
    it = p.device_iter(parser, num_col=num_col, batch_size=batch_size, layout="dense",
                       pack_aux=False)
    batches = [tuple(np.asarray(a) for a in batch) for batch in it]
    stats = it.stats()
    it.close()
    return batches, stats


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


_EPOCH_KEYS = ("retries", "resumes", "giveups", "fatal", "pipeline_restarts",
               "pipeline_giveups")


def _res(stats) -> dict:
    return {k: stats["resilience"][k] for k in _EPOCH_KEYS}


class TestDeviceIterAcceptance:
    """A ``DeviceIter`` epoch over HTTP under fault plans: fail twice then
    succeed byte-identical with exact counters; a fatal fault in one
    attempt; a fault that exhausts the stream budget healed by the bounded
    pipeline restart. The port's epoch, counters and ``fired()`` equal the
    JAX package's under the same plan."""

    @staticmethod
    def _both(http_files, monkeypatch, plan, attempts=None):
        if attempts is not None:
            monkeypatch.setenv("DMLC_RETRY_MAX_ATTEMPTS", str(attempts))
        for p in PKGS.values():
            monkeypatch.setattr(p.http, "_BLOCK", 2048)
        handler, base = http_files
        handler.files["/corpus.libsvm"] = _make_libsvm()
        url = f"{base}/corpus.libsvm"
        out = {}
        for name, p in PKGS.items():
            clean, clean_stats = _collect_epoch(p, url)
            assert clean_stats["resilience"]["retries"] == 0
            p.res.reset_counters()
            with p.faults.inject(plan) as fp:
                faulted, stats = _collect_epoch(p, url)
            _assert_batches_equal(clean, faulted)
            out[name] = (faulted, _res(stats), fp.fired())
        _assert_batches_equal(out["ref"][0], out["port"][0])
        assert out["port"][1:] == out["ref"][1:]
        return out["port"][1], out["port"][2]

    def test_fail_twice_then_succeed_byte_identical(self, http_files, monkeypatch):
        res, fired = self._both(http_files, monkeypatch, "read@2..3=http-503")
        assert fired == 2
        assert res["retries"] == 2 and res["resumes"] == 2
        assert res["giveups"] == 0 and res["pipeline_restarts"] == 0

    def test_pipeline_restart_heals_exhausted_stream_budget(self, http_files, monkeypatch):
        res, fired = self._both(http_files, monkeypatch, "read@2..7=http-503", attempts=3)
        assert fired == 6
        assert res["giveups"] == 2
        assert res["pipeline_restarts"] == 2
        assert res["pipeline_giveups"] == 0

    def test_fatal_fault_surfaces_in_one_attempt(self, pkg, http_files):
        handler, base = http_files
        handler.files["/corpus.libsvm"] = _make_libsvm()
        with pkg.faults.inject("open@1=http-403") as plan:
            with pytest.raises(pkg.err):
                _collect_epoch(pkg, f"{base}/corpus.libsvm")
        assert plan.fired() == 1
        snap = pkg.res.counters_snapshot()
        assert snap["fatal"] >= 1 and snap["retries"] == 0


def test_counters_object_matches_reference():
    for res in (port_res, jax_res):
        res.COUNTERS.reset()
        res.COUNTERS.bump("retries")
        res.record_event("retries", 2)
        base = res.COUNTERS.snapshot()
        res.COUNTERS.bump("cache_rebuilds")
        assert res.counters_snapshot() == res.COUNTERS.snapshot()
        assert res.COUNTERS.delta(base) == res.counters_delta(base)
    assert port_res.COUNTERS.snapshot() == jax_res.COUNTERS.snapshot()
    assert port_res.COUNTERS.snapshot()["retries"] == 3
    assert port_res.COUNTERS.delta(base) == jax_res.COUNTERS.delta(base)
    assert port_res.COUNTERS.snapshot(pipeline="nope") == jax_res.COUNTERS.snapshot(
        pipeline="nope")
    for res in (port_res, jax_res):
        res.reset_counters()
        assert not any(res.COUNTERS.snapshot().values())
