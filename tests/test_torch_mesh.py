"""``dmlc_tpu_torch/parallel/mesh.py``: the counterparts of
``tests/test_mesh.py``'s ten cases, the host-shard / global-batch seam.

A port mesh spans the ranks of a process group (one device a rank), so
the cases that need more than one rank run in one spawned group of 4 gloo
ranks on the CPU; the rest run in this process, where a mesh without a
group spans this process alone. torch has no global tensor: a rank's
batch is its slice of the global batch, and the global batch is the
ranks' slices in rank order, which the group checks by summing each
rank's slice into its place of a zeroed global buffer.
"""

import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from dmlc_tpu_torch.parallel import (data_sharding, host_shard_info, local_batch_to_global,
                                     make_mesh, replicated)
from dmlc_tpu_torch.parallel.launch import run_local

WORLD = 4

WORKER = textwrap.dedent(r'''
    import json, os, sys
    from datetime import timedelta

    import numpy as np
    import torch

    from dmlc_tpu_torch.parallel import (data_sharding, host_shard_info, init_from_env,
                                         local_batch_to_global, make_mesh)
    from dmlc_tpu_torch.parallel.distributed import exit_rank

    init_from_env(device="cpu", timeout=timedelta(seconds=60))
    rank, world = host_shard_info()
    out = {"rank": rank, "identity": [rank, world]}
    default = make_mesh(devices="cpu")
    out["default"] = [list(default.axis_names), list(default.ranks.shape)]
    wide = make_mesh({"data": -1, "model": 2}, devices=["cpu"] * world)
    out["wide"] = [wide.shape, wide.coords, wide.ranks.tolist()]
    try:
        make_mesh({"data": 3}, devices="cpu")
        out["non_dividing"] = None
    except ValueError as exc:
        out["non_dividing"] = str(exc)

    def gather(mesh, t):
        """The global batch: each rank's slice summed into its place."""
        rows = t.shape[0]
        buf = torch.zeros((world * rows,) + tuple(t.shape[1:]), dtype=t.dtype)
        buf[rank * rows:(rank + 1) * rows] = t
        return mesh.all_reduce_(buf)

    # a 16-row global batch: rank r holds rows [4r, 4r + 4)
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    y = (np.arange(16) % 2).astype(np.float32)
    w = np.ones(16, dtype=np.float32)
    per = 16 // world
    sl = slice(rank * per, (rank + 1) * per)
    lx, ly, lw = local_batch_to_global(default, [x[sl], y[sl], w[sl]])
    out["local"] = [lx.tolist(), ly.tolist(), str(lx.device)]
    out["global"] = [gather(default, lx).tolist(), gather(default, ly).tolist(),
                     float(gather(default, lw).sum())]
    out["spec"] = list(data_sharding(default, ndim=2).spec)
    with open(os.path.join(os.environ["OUT"], f"mesh_{rank}.json"), "w") as f:
        json.dump(out, f)
    exit_rank()  # destroys the group and skips torch's teardown at exit
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    script = out / "worker.py"
    script.write_text(WORKER)
    run_local([sys.executable, str(script)], WORLD, timeout=120,
              env=dict(os.environ, OUT=str(out)))
    return [json.loads((out / f"mesh_{r}.json").read_text()) for r in range(WORLD)]


# ---------------- make_mesh ----------------

def test_make_mesh_defaults_to_1d_data_axis(ranks):
    mesh = make_mesh(devices="cpu")  # no group: this process alone
    assert mesh.axis_names == ("data",) and mesh.ranks.shape == (1,)
    assert not mesh.distributed and mesh.device == torch.device("cpu")
    assert all(r["default"] == [["data"], [WORLD]] for r in ranks)


def test_make_mesh_infers_minus_one_axis(ranks):
    for r in ranks:
        shape, coords, layout = r["wide"]
        assert shape == {"data": WORLD // 2, "model": 2}
        # the ranks in row-major order over (data, model)
        assert layout == np.arange(WORLD).reshape(WORLD // 2, 2).tolist()
        assert coords == {"data": r["rank"] // 2, "model": r["rank"] % 2}
    assert make_mesh({"data": -1}, devices="cpu").shape == {"data": 1}


def test_make_mesh_rejects_non_dividing_axes(ranks):
    with pytest.raises(ValueError, match="devices"):
        make_mesh({"data": 3}, devices="cpu")
    assert all("devices" in r["non_dividing"] for r in ranks)


def test_make_mesh_single_device_subset():
    mesh = make_mesh(devices=["cpu"])  # one device a rank, in rank order
    assert mesh.ranks.shape == (1,)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(devices=["cpu", "cpu"])


# ---------------- host_shard_info ----------------

def test_host_shard_info_hint_overrides():
    assert host_shard_info(4) == (0, 4)
    assert host_shard_info(1) == (0, 1)


def test_host_shard_info_defaults_to_process_identity(ranks):
    assert host_shard_info() == (0, 1)  # no group here
    assert [r["identity"] for r in ranks] == [[r, WORLD] for r in range(WORLD)]


# ---------------- local_batch_to_global ----------------

def test_global_batch_shards_preserve_global_order(ranks):
    """The ranks' slices, in rank order, are exactly the global batch: no
    permutation, no overlap; each rank holds a contiguous 4-row slice."""
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    for r in ranks:
        local, _, device = r["local"]
        assert device == "cpu"
        np.testing.assert_array_equal(local, x[4 * r["rank"]:4 * r["rank"] + 4])
        np.testing.assert_array_equal(r["global"][0], x)
        assert r["spec"] == ["data", None]
    np.testing.assert_array_equal(np.concatenate([r["local"][0] for r in ranks]), x)


def test_global_batch_degenerate_single_device_mesh():
    # a world of one: the global batch IS the local batch
    mesh = make_mesh(devices="cpu")
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    (g,) = local_batch_to_global(mesh, [x])
    np.testing.assert_array_equal(g.numpy(), x)
    assert g.device == mesh.device
    assert data_sharding(mesh).spec == ("data",) and replicated(mesh).spec == ()


def test_global_batch_disagreeing_rows_raise():
    """Arrays of one batch that disagree on their rows cannot be placed:
    the error surfaces at placement, not as silent padding or truncation
    (drop_remainder upstream is the sanctioned fix)."""
    mesh = make_mesh(devices="cpu")
    with pytest.raises(ValueError, match="rows"):
        local_batch_to_global(mesh, [np.ones((10, 2), np.float32), np.ones(8, np.float32)])
    with pytest.raises(ValueError, match="axis"):
        local_batch_to_global(mesh, [np.ones(4, np.float32)], axis="model")


def test_global_batch_multiple_arrays_consistent(ranks):
    # the (x, y, w) triple a dense DeviceIter ships lands row-aligned: rank
    # r holds rows [4r, 4r + 4) of every array
    y = (np.arange(16) % 2).astype(np.float32)
    for r in ranks:
        np.testing.assert_array_equal(r["local"][1], y[4 * r["rank"]:4 * r["rank"] + 4])
        np.testing.assert_array_equal(r["global"][1], y)
        assert r["global"][2] == 16.0
