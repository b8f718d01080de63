"""The port's epoch planner and planned block cache, against the JAX package's.

The planner (``dmlc_tpu_torch.data.epoch``) is a numpy copy, so its
outputs are compared byte for byte over a grid: ``block_permutation``,
``row_permutation`` (windowed and full), ``EpochPlan.order`` over host
splits, ``permute_block_rows`` and ``plan_state_dict``.

Then the same seeded corpus goes through the JAX package's Python parser
chain (``create_parser(uri + "?engine=python", threaded=True,
parse_workers=1, chunk_bytes=4096, block_cache=...)``) and the port's
``create_parser(uri, chunk_bytes=4096, block_cache=...)``, each over a
cache file of its own:

- epochs 0-3 (cold, then planned warm) give byte-equal blocks, resume
  annotations and ``plan_state``, for several ``(seed, window, host_id,
  num_hosts)``; the shards of 2 and 3 hosts are disjoint and union to
  each epoch;
- ``state_dict`` equals the JAX package's as JSON at every block of a warm
  planned epoch;
- states restore both ways between the packages (``epoch_plan`` with and
  without ``cold`` / ``seen``, ``block_cache``, ``blocks``, ``split``) to
  byte-equal remaining blocks, also when the cache of a plan state has
  been deleted (it is rebuilt);
- ``pod_identity`` resolved from the DMLC_* contract in two gloo ranks
  spawned by ``run_local`` gives disjoint warm shards that union to the
  epoch.

Bytes are compared as bytes: no tolerance.
"""

import json
import os
import sys

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data import epoch as jax_epoch
from dmlc_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.data import epoch
from dmlc_tpu_torch.data.row_block import RowBlock

CHUNK = 4096


def _corpus(tmp_path, n=1200, name="plan.libsvm"):
    """Label = row id, values tie to it: a row mixup cannot cancel out.
    Rows of 1-4 features, so some blocks are ragged."""
    rng = np.random.default_rng(8)
    path = tmp_path / name
    with open(path, "w") as f:
        for i in range(n):
            cols = np.sort(rng.choice(9, size=1 + i % 4, replace=False))
            f.write(f"{i} " + " ".join(f"{c}:{i}.{c}" for c in cols) + "\n")
    return str(path)


def _jax(path, cache, **kw):
    return jax_create_parser(path + "?engine=python", 0, 1, "libsvm", threaded=True,
                             parse_workers=1, chunk_bytes=CHUNK, block_cache=cache, **kw)


def _port(path, cache, **kw):
    return create_parser(path, 0, 1, "libsvm", chunk_bytes=CHUNK, block_cache=cache, **kw)


def _block_bytes(b) -> bytes:
    return b"".join(np.asarray(a).tobytes() for a in (
        b.offset, b.label, np.asarray(b.index).astype(np.uint64), b.value))


def _js(state) -> str:
    return json.dumps(state, sort_keys=True)


def _drain(parser, n=None):
    """(block bytes, resume annotation as JSON) of the next ``n`` blocks."""
    out = []
    while n is None or len(out) < n:
        b = parser.next_block()
        if b is None:
            break
        out.append((_block_bytes(b), _js(b.resume_state)))
    return out


# ---------------- the planner's functions, byte for byte ----------------

@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 40 + 3])
@pytest.mark.parametrize("ep", [0, 1, 5])
@pytest.mark.parametrize("n", [0, 1, 2, 13, 257])
def test_block_permutation_matches(seed, ep, n):
    got, want = epoch.block_permutation(seed, ep, n), jax_epoch.block_permutation(seed, ep, n)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed,ep,block", [(0, 0, 0), (3, 1, 4), (11, 7, 100)])
@pytest.mark.parametrize("rows,window", [(10, 4), (64, 64), (64, 1000), (300, 16),
                                         (10, 0), (10, 1), (1, 8)])
def test_row_permutation_matches(seed, ep, block, rows, window):
    got = epoch.row_permutation(seed, ep, block, rows, window)
    want = jax_epoch.row_permutation(seed, ep, block, rows, window)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [None, 0, 9])
@pytest.mark.parametrize("ep", [0, 3])
@pytest.mark.parametrize("num_blocks,num_hosts", [(23, 1), (23, 2), (23, 3), (5, 4), (1, 2)])
def test_epoch_plan_order_matches(seed, ep, num_blocks, num_hosts):
    union = []
    for host in range(num_hosts):
        got = epoch.EpochPlan(seed, ep, num_blocks, num_hosts=num_hosts, host_id=host, window=4)
        want = jax_epoch.EpochPlan(seed, ep, num_blocks, num_hosts=num_hosts, host_id=host,
                                   window=4)
        assert got.order.tobytes() == want.order.tobytes()
        assert got.permuted == want.permuted and len(got) == len(want)
        assert got.state(2) == want.state(2)
        for b in range(num_blocks):
            g, w = got.row_order(b, 40), want.row_order(b, 40)
            assert (g is None) == (w is None) and (w is None or g.tobytes() == w.tobytes())
        union += got.order.tolist()
    assert sorted(union) == list(range(num_blocks))


def _csr(uniform: bool, n=24, k=3, seed=0):
    rng = np.random.default_rng(seed)
    if uniform:
        nnz = np.full(n, k)
        index = np.tile(np.array([5, 7, 9], np.uint64), n)
    else:
        nnz = rng.integers(0, 5, size=n)
        index = rng.integers(0, 50, size=int(nnz.sum())).astype(np.uint64)
    offset = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    arrays = dict(offset=offset, label=rng.normal(size=n).astype(np.float32), index=index,
                  value=rng.normal(size=int(nnz.sum())).astype(np.float32),
                  weight=rng.random(n).astype(np.float32), qid=np.arange(n, dtype=np.int64))
    return RowBlock(**arrays), JaxRowBlock(**arrays)


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("perm_seed", [0, 1, 2])
def test_permute_block_rows_matches(uniform, perm_seed):
    port_blk, jax_blk = _csr(uniform)
    assert epoch.uniform_column_pattern(port_blk) == jax_epoch.uniform_column_pattern(jax_blk)
    perm = np.random.default_rng(perm_seed).permutation(len(port_blk))
    for flag in (False, uniform):
        got = epoch.permute_block_rows(port_blk, perm, uniform_columns=flag)
        want = jax_epoch.permute_block_rows(jax_blk, perm, uniform_columns=flag)
        for name in ("offset", "label", "index", "value", "weight", "qid"):
            assert getattr(got, name).tobytes() == getattr(want, name).tobytes(), name


@pytest.mark.parametrize("unit", ["block", "batch"])
def test_plan_state_dict_matches(unit):
    for args in [(None, 0, 0, 0, 0, 1), (3, 16, 2, 5, 1, 3)]:
        assert _js(epoch.plan_state_dict(*args, unit=unit)) == _js(
            jax_epoch.plan_state_dict(*args, unit=unit))


# ---------------- planned epochs through create_parser ----------------

PLANS = [dict(shuffle_seed=0), dict(shuffle_seed=3, shuffle_window=16),
         dict(shuffle_seed=5, shuffle_window=1000), dict(shuffle_seed=1, pod_sharding=(1, 2)),
         dict(shuffle_seed=2, shuffle_window=8, pod_sharding=(2, 3)),
         dict(pod_sharding=(0, 2))]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_planned_epochs_match_reference(tmp_path, kw):
    path = _corpus(tmp_path)
    jp, pp = _jax(path, str(tmp_path / "j.bc"), **kw), _port(path, str(tmp_path / "p.bc"), **kw)
    for ep in range(4):
        if ep:
            jp.before_first()
            pp.before_first()
            # a second rewind with nothing delivered keeps the epoch
            jp.before_first()
            pp.before_first()
        assert jp.cache_state == pp.cache_state == ("cold" if ep == 0 else "warm")
        assert _drain(pp) == _drain(jp), ep
        assert _js(pp.plan_state) == _js(jp.plan_state)
        assert pp.plan_state["epoch"] == ep
    assert pp.stage_seconds()["cache_read"] > 0
    jp.close()
    pp.close()


@pytest.mark.parametrize("num_hosts", [2, 3])
def test_pod_shards_disjoint_union(tmp_path, num_hosts):
    path = _corpus(tmp_path)
    whole = _port(path, str(tmp_path / "all.bc"))
    epoch0 = sorted(raw for raw, _ in _drain(whole))
    whole.close()
    hosts = [_port(path, str(tmp_path / "all.bc"), shuffle_seed=4,
                   pod_sharding=(h, num_hosts)) for h in range(num_hosts)]
    for ep in range(1, 3):
        shards = [[raw for raw, _ in _drain(h)] for h in hosts]
        flat = [raw for s in shards for raw in s]
        assert len(set(flat)) == len(flat)          # disjoint
        assert sorted(flat) == epoch0               # the union is the epoch
        assert max(map(len, shards)) - min(map(len, shards)) <= 1
        for h in hosts:
            h.before_first()
    for h in hosts:
        h.close()


def test_states_equal_at_every_block(tmp_path):
    path = _corpus(tmp_path)
    kw = dict(shuffle_seed=6, shuffle_window=8)
    jp, pp = _jax(path, str(tmp_path / "j.bc"), **kw), _port(path, str(tmp_path / "p.bc"), **kw)
    for ep in range(2):
        for p in (jp, pp):
            p.before_first()
        assert _js(pp.state_dict()) == _js(jp.state_dict())
        while True:
            jb, pb = jp.next_block(), pp.next_block()
            assert (jb is None) == (pb is None)
            assert _js(pp.state_dict()) == _js(jp.state_dict())
            if jb is None:
                break
    assert pp.state_dict()["kind"] == "epoch_plan"
    jp.close()
    pp.close()


def _state_at(make, path, cache, kw, state_kind, k=3):
    """A pipeline built by ``make``, stopped after ``k`` blocks of the pass
    that gives ``state_kind``; returns (state, the rest of that pass)."""
    p = make(path, cache, **kw)
    if state_kind not in ("split", "cold_plan"):
        _drain(p)                 # the cold pass publishes the cache
        p.before_first()          # a warm epoch
    _drain(p, k)
    if state_kind == "blocks":
        state = {"kind": "blocks", "blocks": k}
    else:
        state = p.state_dict()
    rest = _drain(p)
    p.close()
    return state, rest


STATES = [  # (state kind, knobs of the pipeline the state comes from)
    ("epoch_plan", dict(shuffle_seed=5, shuffle_window=8)),
    ("cold_plan", dict(shuffle_seed=5, pod_sharding=(1, 2))),
    ("block_cache", {}),
    ("blocks", {}),
    ("split", {}),
]


@pytest.mark.parametrize("origin", ["jax", "port"])
@pytest.mark.parametrize("state_kind,kw", STATES, ids=[s for s, _ in STATES])
@pytest.mark.parametrize("restore_into", ["same", "planned"])
def test_states_restore_across_packages(tmp_path, origin, state_kind, kw, restore_into):
    """A state of either package restored into a fresh pipeline of each
    package (its own published cache, built with the state's knobs or with
    another seed) gives the same stream in both, blocks and annotations,
    and its blocks are the ones the first pipeline went on to deliver: a
    sequential state in a planned pipeline serves the rest sequentially, a
    sharded cold state the published cache through the shard filter."""
    path = _corpus(tmp_path)
    src = _jax if origin == "jax" else _port
    state, rest = _state_at(src, path, str(tmp_path / "src.bc"), kw, state_kind)
    want_kind = {"cold_plan": "epoch_plan", "blocks": "blocks"}.get(state_kind, state_kind)
    assert state["kind"] == want_kind and (state_kind != "cold_plan" or "cold" in state)
    dst_kw = dict(shuffle_seed=17) if restore_into == "planned" else kw
    streams = []
    for make, name in ((_jax, "j.bc"), (_port, "p.bc")):
        build = make(path, str(tmp_path / name), **dst_kw)
        _drain(build)         # publishes this package's own cache
        build.close()
        fresh = make(path, str(tmp_path / name), **dst_kw)
        fresh.load_state(json.loads(_js(state)))
        streams.append(_drain(fresh))
        fresh.close()
    assert streams[1] == streams[0]
    assert [raw for raw, _ in streams[1]] == [raw for raw, _ in rest]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_plan_state_restores_after_the_cache_is_deleted(tmp_path, direction):
    path = _corpus(tmp_path)
    kw = dict(shuffle_seed=8, shuffle_window=4)
    src, dst = (_jax, _port) if direction == "jax_to_port" else (_port, _jax)
    state, rest = _state_at(src, path, str(tmp_path / "src.bc"), kw, "epoch_plan", k=2)
    cache = str(tmp_path / "dst.bc")
    assert not os.path.exists(cache)
    fresh = dst(path, cache, **kw)
    assert fresh.cache_state == "cold"
    fresh.load_state(state)       # one silent rebuild, then the plan position
    assert fresh.cache_state == "warm" and os.path.exists(cache)
    assert _drain(fresh) == rest
    fresh.close()


def test_cold_sharded_state_resumes_the_cold_pass(tmp_path):
    """A sharded cold pass's state restored before any cache exists resumes
    the cold pass itself, in both packages alike."""
    path = _corpus(tmp_path)
    kw = dict(shuffle_seed=2, pod_sharding=(0, 2))
    state, rest = _state_at(_jax, path, str(tmp_path / "j.bc"), kw, "cold_plan", k=2)
    os.remove(str(tmp_path / "j.bc"))
    for make, name in ((_jax, "j2.bc"), (_port, "p2.bc")):
        fresh = make(path, str(tmp_path / name), **kw)
        fresh.load_state(state)
        assert fresh.cache_state == "cold"
        assert _drain(fresh) == rest
        fresh.close()


# ---------------- pod identity from the DMLC_* contract ----------------

_WORKER = r'''
import json, os, sys
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.parallel import init_from_env, pod_identity
init_from_env(device="cpu")
path, cache, out_dir = sys.argv[1:4]
p = create_parser(path, 0, 1, "libsvm", chunk_bytes=4096, block_cache=cache,
                  shuffle_seed=3, pod_sharding=True)
epochs = []
for ep in range(3):
    if ep:
        p.before_first()
    labels = []
    while (b := p.next_block()) is not None:
        labels += [int(v) for v in b.label]
    epochs.append(labels)
out = os.path.join(out_dir, "rank%s.json" % os.environ["DMLC_TASK_ID"])
json.dump({"identity": list(pod_identity()), "plan": p.plan_state, "epochs": epochs},
          open(out, "w"))
p.close()
'''


def test_pod_identity_from_the_env_contract_in_two_gloo_ranks(tmp_path):
    """Each rank resolves ``(DMLC_TASK_ID, DMLC_NUM_WORKER)`` from the
    contract ``run_local`` exports; over one published cache the ranks'
    epochs (the cold one too) are disjoint and union to the corpus."""
    from dmlc_tpu_torch.parallel.launch import run_local

    path = _corpus(tmp_path)
    cache = str(tmp_path / "shared.bc")
    build = _port(path, cache)
    _drain(build)
    build.close()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    run_local([sys.executable, str(script), path, cache, str(tmp_path)], 2, timeout=240)
    res = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert [r["identity"] for r in res] == [[0, 2], [1, 2]]
    assert [(r["plan"]["host_id"], r["plan"]["num_hosts"]) for r in res] == [(0, 2), (1, 2)]
    for ep in range(3):
        a, b = res[0]["epochs"][ep], res[1]["epochs"][ep]
        assert not set(a) & set(b)
        assert sorted(a + b) == list(range(1200))
