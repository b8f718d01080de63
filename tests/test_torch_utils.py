"""The port's utils layer against the JAX package's (``tests/test_utils.py``'s
14 cases, each run through both packages on the same inputs).

- ``check``, the registry, parameters (defaults, ``init`` with unknown
  keys, ranges, enums, aliases, required fields, the JSON and ``doc()``),
  typed environment access, ``Config`` (quotes, comments, the two value
  modes, escaped quotes, ``to_proto_string``, errors) and the serializer:
  the same results, error texts and bytes in both;
- the format dispatch: ``create_parser`` looks its format up in
  ``PARSER_REGISTRY`` (``Registry.get("parser")``) in both packages, the
  three formats registered with the same descriptions; a format a test
  registers on each package's registry reaches its ``create_parser`` with
  the same arguments and gives the same rows, and the unknown-format
  errors list the same names.
"""

import io

import numpy as np
import pytest

import dmlc_tpu.utils as jax_utils
from dmlc_tpu.data import parsers as jax_parsers
from dmlc_tpu.utils import params as jax_params
from dmlc_tpu.utils import serializer as jax_ser
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
import dmlc_tpu_torch.utils as port_utils
from dmlc_tpu_torch.data import parsers as port_parsers
from dmlc_tpu_torch.utils import params as port_params
from dmlc_tpu_torch.utils import serializer as port_ser
from dmlc_tpu_torch.utils.check import DMLCError

PKGS = {"port": (port_utils, port_params, port_ser, DMLCError),
        "jax": (jax_utils, jax_params, jax_ser, JaxDMLCError)}


def _both(case, *args, **kw):
    """``case(pkg, *args, **kw)`` for both packages; the port's result."""
    got, want = case("port", *args, **kw), case("jax", *args, **kw)
    assert got == want
    return got


def _error(pkg, fn, *args, **kw) -> str:
    """The text of the DMLCError ``fn`` raises in ``pkg``."""
    with pytest.raises(PKGS[pkg][3]) as exc:
        fn(*args, **kw)
    return str(exc.value)


# ---------------- check ----------------

def _check_case(pkg):
    u = PKGS[pkg][0]
    u.check(True)
    u.check_eq(1, 1)
    return [_error(pkg, u.check, False, "boom"), _error(pkg, u.check_eq, 1, 2),
            _error(pkg, u.check_lt, 3, 2)]


def test_check_raises():
    assert "boom" in _both(_check_case)[0]


# ---------------- registry ----------------

def _registry_case(pkg):
    u = PKGS[pkg][0]
    reg = u.Registry.get("test_torch_reg_1")
    reg._entries.clear()
    assert u.Registry.get("test_torch_reg_1") is reg

    @reg.register("foo", description="a foo")
    def make_foo():
        return "foo!"

    out = [reg.find("foo").body(), reg.find("foo").description, reg.find("bar") is None]
    reg.add_alias("foo", "foo2")
    out += [reg.create("foo2"), _error(pkg, reg.lookup, "nope")]
    out.append(_error(pkg, reg.register("foo"), lambda: None))
    reg.register("foo", override=True)(lambda: "again")
    out += [reg.create("foo"), _error(pkg, reg.add_alias, "zz", "y"),
            _error(pkg, reg.add_alias, "foo", "foo2"), list(reg.list_names())]
    entry = reg.find("foo").describe("described").add_argument("n", "int", "a count")
    out += [entry.description, entry.arguments]
    return out


def test_registry_register_find_alias():
    got = _both(_registry_case)
    assert got[0] == "foo!" and got[3] == "foo!" and got[6] == "again"
    assert got[9] == ["foo", "foo2"]


# ---------------- params ----------------

def _my_param(pkg):
    P = PKGS[pkg][1]

    class MyParam(P.Parameter):
        size = P.field(int, default=100, lower_bound=0, help="a size")
        name = P.field(str, default="x")
        ratio = P.field(float, default=0.5, lower_bound=0.0, upper_bound=1.0)
        kind = P.field(str, default="a", enum=["a", "b"])
        num_hidden = P.field(int, default=0, aliases=["nhidden"])

    return MyParam


def _param_init_case(pkg):
    p = _my_param(pkg)()
    out = [p.size, p.name]
    unknown = p.init({"size": "7", "junk": "1"}, allow_unknown=True)
    return out + [p.size, unknown, _error(pkg, p.init, {"junk": "1"})]


def test_param_defaults_and_init():
    got = _both(_param_init_case)
    assert got[:4] == [100, "x", 7, {"junk": "1"}]


def _param_range_case(pkg):
    p = _my_param(pkg)()
    out = [_error(pkg, p.init, {"size": "-1"}), _error(pkg, p.init, {"ratio": "1.5"}),
           _error(pkg, p.init, {"kind": "c"}), _error(pkg, p.init, {"size": "abc"})]
    p.init({"nhidden": "32"})
    return out + [p.num_hidden]


def test_param_range_enum_alias():
    assert _both(_param_range_case)[-1] == 32


def _param_json_case(pkg):
    P = PKGS[pkg][1]

    class Req(P.Parameter):
        must = P.field(int)

    out = [_error(pkg, Req), Req(must=3).must]
    MyParam = _my_param(pkg)
    text = MyParam(size=9).save_json()
    q = MyParam()
    leftover = q.load_json(text.replace("}", ', "extra": 1}'), allow_unknown=True)
    return out + [text, q.to_dict(), leftover, MyParam.doc(), Req.doc()]


def test_param_required_and_json():
    got = _both(_param_json_case)
    assert got[1] == 3 and got[3]["size"] == 9 and got[4] == {"extra": 1}
    assert "size" in got[5] and "required" in got[6]


def _env_case(pkg, monkeypatch):
    P = PKGS[pkg][1]
    monkeypatch.setenv("DMLC_TEST_KEY", "42")
    out = [P.get_env("DMLC_TEST_KEY", int, 0), P.get_env("DMLC_TEST_MISSING", int, 7)]
    P.set_env("DMLC_TEST_KEY2", 5)
    out.append(P.get_env("DMLC_TEST_KEY2", int, 0))
    monkeypatch.setenv("DMLC_TEST_BOOL", "true")
    monkeypatch.setenv("DMLC_TEST_EMPTY", "")
    out += [P.get_env("DMLC_TEST_BOOL", bool, False), P.get_env("DMLC_TEST_EMPTY", int, 3)]
    monkeypatch.delenv("DMLC_TEST_KEY2")
    return out


def test_env_access(monkeypatch):
    assert _both(_env_case, monkeypatch) == [42, 7, 5, True, 3]


# ---------------- config ----------------

def _config_case(pkg, text, **kw):
    cfg = PKGS[pkg][0].Config(text, **kw)
    return [cfg.items(), {k: cfg.get_all(k) for k, _ in cfg.items()},
            cfg.to_proto_string(), "a" in cfg, "zz" in cfg]


def test_config_basic():
    got = _both(_config_case, 'a = 1\nb = "hello # not comment" # real comment\nc=2.5\n')
    assert got[0] == [("a", "1"), ("b", "hello # not comment"), ("c", "2.5")]
    assert got[3] and not got[4]


def test_config_override_and_multi():
    assert _both(_config_case, "k = 1\nk = 2\nj = 0\n")[1] == {"k": ["2"], "j": ["0"]}
    assert _both(_config_case, "k = 1\nk = 2\n", multi_value=True)[1] == {"k": ["1", "2"]}


def test_config_escaped_quote_and_proto():
    got = _both(_config_case, 's = "say \\"hi\\""\nn = 3\n')
    assert got[0] == [("s", 'say "hi"'), ("n", "3")]
    assert got[2] == 's : "say "hi""\nn : 3\n'


def _config_errors_case(pkg):
    Config = PKGS[pkg][0].Config
    return [_error(pkg, Config, "a = "), _error(pkg, Config, 'a = "unterminated'),
            _error(pkg, Config, "a b c"), _error(pkg, Config("").get, "x"),
            Config("").to_proto_string()]


def test_config_errors():
    assert _both(_config_errors_case)[-1] == ""


# ---------------- serializer ----------------

def _scalar_case(pkg):
    ser = PKGS[pkg][2]
    buf = io.BytesIO()
    ser.write_scalar(buf, 0x01020304, "uint32")
    wire = buf.getvalue()
    buf.seek(0)
    return [wire, ser.read_scalar(buf, "uint32")]


def test_scalar_roundtrip_little_endian():
    assert _both(_scalar_case) == [b"\x04\x03\x02\x01", 0x01020304]


OBJ = {"a": 1, "b": 2.5, "c": "hey", "d": [1, 2, [3, "x"]], "e": None, "f": True,
       "g": b"\x00\x01", "arr": np.arange(6, dtype=np.float32).reshape(2, 3)}


def _obj_case(pkg):
    ser = PKGS[pkg][2]
    buf = io.BytesIO()
    ser.write_obj(buf, OBJ)
    wire = buf.getvalue()
    buf.seek(0)
    out = ser.read_obj(buf)
    arr = out.pop("arr")
    return [wire, out, arr.tobytes(), arr.shape, str(arr.dtype)]


def test_obj_roundtrip():
    got = _both(_obj_case)
    assert got[1]["d"] == [1, 2, [3, "x"]] and got[1]["f"] is True
    assert got[2] == OBJ["arr"].tobytes()


def _ndarray_case(pkg):
    ser = PKGS[pkg][2]
    out = []
    for dtype in (np.uint64, np.int32, np.float64, np.uint8):
        buf = io.BytesIO()
        ser.write_ndarray(buf, np.array([1, 2, 3], dtype=dtype))
        wire = buf.getvalue()
        buf.seek(0)
        arr = ser.read_ndarray(buf)
        out.append((wire, str(arr.dtype), arr.tolist()))
    return out


def test_ndarray_dtype_preserved():
    got = _both(_ndarray_case)
    assert [g[1] for g in got] == ["uint64", "int32", "float64", "uint8"]


def test_truncated_stream_raises():
    assert _both(lambda pkg: _error(pkg, PKGS[pkg][2].read_scalar, io.BytesIO(b"\x01\x02"),
                                    "uint64"))


# ---------------- the format dispatch through the registry ----------------

REG_PKGS = {"port": (port_parsers, port_utils.Registry), "jax": (jax_parsers, jax_utils.Registry)}


def test_parser_registry_holds_the_formats():
    for pkg, (parsers, registry) in REG_PKGS.items():
        assert parsers.PARSER_REGISTRY is registry.get("parser")
    descr = {pkg: {n: parsers.PARSER_REGISTRY.find(n).description
                   for n in parsers.PARSER_REGISTRY.list_names()}
             for pkg, (parsers, _) in REG_PKGS.items()}
    assert descr["port"] == descr["jax"] == {"csv": "dense csv format",
                                             "libfm": "libfm field:index:value format",
                                             "libsvm": "libsvm text format"}


def _rows(parser):
    out = []
    for block in parser:
        out.append((np.asarray(block.label).tolist(), np.asarray(block.offset).tolist(),
                    np.asarray(block.index).tolist(), np.asarray(block.value).tolist()))
    parser.close()
    return out


def test_a_registered_format_reaches_create_parser(tmp_path):
    path = tmp_path / "corpus.tsvsvm"
    path.write_text("".join(f"{i % 2} 0:{i}.5 3:{i % 7}\n" for i in range(300)))
    calls = {pkg: [] for pkg in REG_PKGS}
    for pkg, (parsers, _) in REG_PKGS.items():
        libsvm = parsers.PARSER_REGISTRY.find("libsvm").body

        def factory(uri, args, part_index, num_parts, index_dtype, threaded, _pkg=pkg,
                    _libsvm=libsvm, **kw):
            calls[_pkg].append((uri, dict(args), part_index, num_parts,
                                np.dtype(index_dtype).str, threaded, sorted(kw)))
            return _libsvm(uri, args, part_index, num_parts, index_dtype, threaded, **kw)

        parsers.PARSER_REGISTRY.register("tsvsvm", "a libsvm alias for the test")(factory)
    try:
        errors = {}
        for pkg, (parsers, _) in REG_PKGS.items():
            errors[pkg] = _error(pkg, parsers.create_parser, str(path), 0, 1, "nosuchfmt")
        got = _rows(port_parsers.create_parser(str(path) + "?label_column=0", 0, 1, "tsvsvm",
                                               threaded=False))
        want = _rows(jax_parsers.create_parser(str(path) + "?label_column=0", 0, 1, "tsvsvm",
                                               threaded=False))
        assert got == want and len(got) > 0 and sum(len(b[0]) for b in got) == 300
        assert calls["port"] == calls["jax"] and len(calls["port"]) == 1
        assert calls["port"][0][1] == {"label_column": "0"}
        assert errors["port"] == errors["jax"] == (
            "unknown parser format 'nosuchfmt'; known: ['csv', 'libfm', 'libsvm', 'tsvsvm']")
    finally:
        for parsers, _ in REG_PKGS.values():
            with parsers.PARSER_REGISTRY._lock:
                parsers.PARSER_REGISTRY._entries.pop("tsvsvm", None)
    assert _error("port", port_parsers.create_parser, str(path), 0, 1, "tsvsvm") == (
        "unknown parser format 'tsvsvm'; known: ['csv', 'libfm', 'libsvm']")
