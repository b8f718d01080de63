"""The port's public surface against the JAX package's, module by module.

One case per ``*.py`` under ``dmlc_tpu/``, mapped to its counterpart under
``dmlc_tpu_torch/`` (the same path, but for :data:`RENAMED`). For every
public function, class and module constant the JAX module defines (its own
top-level statements, not its imports), the port's module has the name; a
class has every public method and property of the JAX class (those the
JAX package defines, inherited ones included); and every function and
method accepts each parameter name of the JAX signature by name, with the
required positionals in the JAX order. So a call written for the JAX
package means the same in the port, and nothing the port trimmed can go
unnoticed.

:data:`EXEMPT` holds the names that exist only as a Pallas or XLA
mechanism, each with its port counterpart and the reason. A test below
keeps it honest: an entry must name something the JAX package still has,
contain ``pallas`` or ``interpret`` (or be listed as returning a JAX type
the port replaces with one of its own), and point at a port name that
exists.
"""

import ast
import importlib
import inspect
import os

import pytest

import dmlc_tpu
import dmlc_tpu_torch

JAX_ROOT = os.path.dirname(os.path.abspath(dmlc_tpu.__file__))
PORT_ROOT = os.path.dirname(os.path.abspath(dmlc_tpu_torch.__file__))

# JAX modules whose counterpart has another path in the port
RENAMED = {"native/__init__.py": "native.py", "ops/pallas_sparse.py": "ops/ell_matvec.py"}

# (JAX module, name or function.parameter) -> (port counterpart
# "module:name", why the JAX name has no twin)
EXEMPT = {
    ("ops/pallas_sparse.py", "ell_matvec_pallas"): (
        "ops/ell_matvec.py:ell_matvec_cuda", "K1's Pallas entry; the port's is its CUDA wrapper"),
    ("ops/pallas_sparse.py", "pallas_band"): (
        "ops/ell_matvec.py:ell_matvec_auto",
        "the TPU win band of the Pallas K1; the port routes a 1-D table on the card to "
        "its kernel (and dw by dw_route), as measured on the H100"),
    ("ops/pallas_sparse.py", "ell_matvec_auto.use_pallas"): (
        "ops/ell_matvec.py:ell_matvec_auto",
        "forces the Pallas route; the port's route is the tensor's device"),
    ("ops/device_decode.py", "widen_span_pallas"): (
        "ops/device_decode.py:widen_span_cuda", "K2's Pallas entry; the port's is its CUDA wrapper"),
    ("ops/device_decode.py", "pallas_decode_eligible"): (
        "ops/device_decode.py:decode_span",
        "the Pallas kernel's tile rule; the CUDA route takes every span on the card"),
    ("ops/device_decode.py", "decode_span.use_pallas"): (
        "ops/device_decode.py:decode_span", "forces the Pallas route; the port's is the device"),
    ("ops/device_decode.py", "decode_span.interpret"): (
        "ops/device_decode.py:decode_span",
        "Pallas interpret mode; the port's CPU route is the plain version"),
}

# exempt names that return a JAX type the port replaces with one of its
# own (none yet: block_to_bcoo returns a torch sparse tensor instead)
JAX_TYPED = set()


def _jax_modules():
    out = []
    for root, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_ROOT).replace(os.sep, "/"))
    return sorted(out)


def _module_name(pkg: str, rel: str) -> str:
    rel = rel[:-3]
    if rel == "__init__" or rel.endswith("/__init__"):
        rel = rel[:-len("__init__")].rstrip("/")
    return pkg + ("." + rel.replace("/", ".") if rel else "")


def _defined_names(rel: str) -> dict:
    """The public names a module's own top-level statements bind: functions,
    classes and constants (assignments), not imports."""
    with open(os.path.join(JAX_ROOT, rel)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = "function"
        elif isinstance(node, ast.ClassDef):
            out[node.name] = "class"
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = "constant"
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _required_positionals(sig: inspect.Signature) -> list:
    return [n for n, p in sig.parameters.items()
            if p.default is p.empty
            and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _signature_gaps(label: str, exempt_prefix: tuple, jax_fn, port_fn) -> list:
    try:
        want, got = inspect.signature(jax_fn), inspect.signature(port_fn)
    except (TypeError, ValueError):  # builtins without a signature
        return []
    gaps = []
    for name, p in want.parameters.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if (exempt_prefix + (f"{label}.{name}",)) in EXEMPT:
            continue
        if name not in got.parameters:
            gaps.append(f"{label}: no parameter {name!r}")
    if _required_positionals(want) != _required_positionals(got):
        gaps.append(f"{label}: required positionals {_required_positionals(got)}, "
                    f"JAX's {_required_positionals(want)}")
    return gaps


def _class_gaps(rel: str, name: str, jax_cls, port_cls) -> list:
    gaps = []
    own = [k for k in jax_cls.__mro__ if k.__module__.startswith("dmlc_tpu.")]
    attrs = {a for k in own for a in vars(k) if not a.startswith("_")} | {"__init__"}
    for attr in sorted(attrs):
        label = f"{name}.{attr}"
        if not hasattr(port_cls, attr):
            gaps.append(f"{label}: missing")
            continue
        static = inspect.getattr_static(jax_cls, attr)
        if isinstance(static, property) or not callable(getattr(jax_cls, attr)):
            continue
        if attr == "__init__" and getattr(jax_cls, "__init__") is object.__init__:
            continue
        gaps += _signature_gaps(label, (rel,), getattr(jax_cls, attr), getattr(port_cls, attr))
    return gaps


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_module_covers_reference_module(rel):
    port_rel = RENAMED.get(rel, rel)
    assert os.path.exists(os.path.join(PORT_ROOT, port_rel)), f"no counterpart of {rel}"
    jax_mod = importlib.import_module(_module_name("dmlc_tpu", rel))
    port_mod = importlib.import_module(_module_name("dmlc_tpu_torch", port_rel))
    gaps = []
    for name, kind in sorted(_defined_names(rel).items()):
        if (rel, name) in EXEMPT:
            continue
        if not hasattr(port_mod, name):
            gaps.append(f"{name} ({kind}): missing")
            continue
        jax_obj, port_obj = getattr(jax_mod, name), getattr(port_mod, name)
        if kind == "class" and inspect.isclass(jax_obj):
            gaps += _class_gaps(rel, name, jax_obj, port_obj)
        elif kind == "function" and callable(jax_obj):
            gaps += _signature_gaps(name, (rel,), jax_obj, port_obj)
    assert not gaps, f"{rel} -> {port_rel}:\n" + "\n".join(gaps)


def _port_attr(spec: str):
    mod_rel, _, name = spec.partition(":")
    mod = importlib.import_module(_module_name("dmlc_tpu_torch", mod_rel))
    return getattr(mod, name, None)


@pytest.mark.parametrize("key", sorted(EXEMPT), ids=lambda k: f"{k[0]}:{k[1]}")
def test_exemptions_are_pallas_mechanisms_with_a_port_counterpart(key):
    rel, qual = key
    counterpart, reason = EXEMPT[key]
    assert reason
    assert ("pallas" in qual or "interpret" in qual or key in JAX_TYPED), qual
    jax_mod = importlib.import_module(_module_name("dmlc_tpu", rel))
    fn, _, param = qual.partition(".")
    assert hasattr(jax_mod, fn), f"stale exemption: {rel} has no {fn}"
    if param:
        assert param in inspect.signature(getattr(jax_mod, fn)).parameters, qual
    assert callable(_port_attr(counterpart)), counterpart


def test_every_reference_module_maps_to_its_own_port_module():
    """Each JAX module maps to a port module of its own, which exists."""
    mapped = {RENAMED.get(rel, rel) for rel in _jax_modules()}
    assert len(mapped) == len(_jax_modules())
    assert all(os.path.exists(os.path.join(PORT_ROOT, rel)) for rel in mapped)
