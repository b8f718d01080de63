"""The port's package exports against the JAX package's (fault C10).

Each package of the port exports, in its ``__all__``, every name the JAX
package's ``__all__`` exports, and every exported name imports. The only
names left out are those of the modules still to be ported and the
port's deliberate absences, listed below so that the list shrinks as the
port grows.
"""

import importlib

import pytest

# every package of both; the JAX package's tracker/ and service/ have no
# port package yet (still to port), and its io/*_filesys.py cloud members
# export nothing through io's __all__
PACKAGES = ["", ".io", ".data", ".utils", ".ops", ".models", ".parallel", ".store"]

# JAX names without a port counterpart yet, by package: the modules still
# in the queue (utils/{registry,config,concurrency,thread_group}), and the
# deliberate absences
EXEMPT = {
    "": {"Registry"},                      # utils/registry.py, still to port
    ".io": {"FaultPlan", "inject", "maybe_fail"},  # io/faults.py: no fault seam, deliberately
    ".utils": {"Registry",                 # utils/registry.py
               "Config",                   # utils/config.py
               "ConcurrentBlockingQueue", "Spinlock",  # utils/concurrency.py
               "ManagedThread", "ShutdownToken", "ThreadGroup",  # utils/thread_group.py
               "blocking_queue_thread", "timer_thread"},
    # the JAX BCOO array and the Pallas entry: the port's counterparts are
    # ops.sparse.block_to_bcoo_host and ops.ell_matvec.ell_matvec_cuda; the
    # plain ELL matvec, ops.sparse.ell_matvec, whose name in ops is K1's
    # module (ops.ell_matvec), and which is also JAX's ell_matmul on a 2-D
    # table; and segment_csr_matvec, which no code of either package calls
    ".ops": {"block_to_bcoo", "ell_matvec_pallas", "ell_matvec", "ell_matmul",
             "segment_csr_matvec"},
}


@pytest.mark.parametrize("pkg", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_port_all_covers_reference_all(pkg):
    jax_mod = importlib.import_module("dmlc_tpu" + pkg)
    port_mod = importlib.import_module("dmlc_tpu_torch" + pkg)
    want = set(jax_mod.__all__)
    have = set(port_mod.__all__)
    exempt = EXEMPT.get(pkg, set())
    assert not (exempt & have), f"exempt names now exported: {sorted(exempt & have)}"
    assert exempt <= want, f"stale exemptions: {sorted(exempt - want)}"
    assert want - exempt <= have, f"missing from {pkg or 'top'}: {sorted(want - exempt - have)}"


@pytest.mark.parametrize("pkg", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_every_exported_name_imports(pkg):
    port_mod = importlib.import_module("dmlc_tpu_torch" + pkg)
    assert len(set(port_mod.__all__)) == len(port_mod.__all__)
    for name in port_mod.__all__:
        exec(f"from dmlc_tpu_torch{pkg} import {name}", {})
        assert getattr(port_mod, name) is not None


def test_ops_ell_matvec_is_the_kernel_module():
    import dmlc_tpu_torch.ops as ops
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops.sparse import ell_matvec

    assert k1 is ops.ell_matvec and hasattr(k1, "launches") and callable(ell_matvec)


def test_the_c10_names_import():
    from dmlc_tpu_torch import Parameter, __version__
    from dmlc_tpu_torch.data import (AutoTuner, BlockCacheIter, EpochPlan, Knob,  # noqa: F401
                                     ParseTierTuner, block_permutation, permute_block_rows,
                                     row_permutation)
    from dmlc_tpu_torch.io import (BlockCacheReader, BlockCacheWriter,  # noqa: F401
                                   CachedInputSplit, FileInfo, LocalFileSystem,
                                   RecordIOChunkReader, RecordIOReader, RecordIOWriter,
                                   RetryPolicy, classify, default_policy, get_filesystem,
                                   open_block_cache, read_index_file, source_signature,
                                   write_indexed_recordio)
    from dmlc_tpu_torch.utils import Parameter as UtilsParameter
    from dmlc_tpu_torch.utils import field  # noqa: F401

    import dmlc_tpu

    assert __version__ == dmlc_tpu.__version__ == "0.1.0"
    assert Parameter is UtilsParameter


def test_packages_cover_every_package_of_both():
    import pkgutil

    import dmlc_tpu
    import dmlc_tpu_torch

    jax_pkgs = {m.name for m in pkgutil.iter_modules(dmlc_tpu.__path__) if m.ispkg}
    port_pkgs = {m.name for m in pkgutil.iter_modules(dmlc_tpu_torch.__path__) if m.ispkg}
    assert {p[1:] for p in PACKAGES if p} == (jax_pkgs & port_pkgs) - {"native"}
    assert jax_pkgs - port_pkgs == {"native", "tracker", "service"}
