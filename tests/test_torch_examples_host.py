"""The port's host examples against the repository's JAX examples.

- ``dmlc_tpu_torch.examples.parameter_demo`` prints what
  ``examples/parameter_demo.py`` prints, character for character, for the
  same arguments (an alias, an unknown key, none at all);
- ``dmlc_tpu_torch.examples.checkpoint_resume --device cpu``, in a process
  that cannot import JAX, prints what ``examples/checkpoint_resume.py``
  prints: the same checkpoint, the same resumed batch count, the resumed
  stream equal to the uninterrupted pass; and it runs on a corpus written
  to ``mem://``.
"""

import importlib.util
import os
import subprocess
import sys

import pytest

from dmlc_tpu_torch.examples import checkpoint_resume, parameter_demo
from dmlc_tpu_torch.io.filesystem import MemoryFileSystem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [["size=7", "name=gemfield", "nhidden=32"],
                                  ["ratio=0.25", "junk=1", "plain"], []],
                         ids=["alias", "unknown", "defaults"])
def test_parameter_demo_prints_the_reference_output(argv, capsys, monkeypatch):
    parameter_demo.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["parameter_demo.py", *argv])
    _jax_example("parameter_demo").main()
    want = capsys.readouterr().out
    assert got == want
    assert got.startswith("Parameters of MyParam:\n") and "json   : {" in got


def test_checkpoint_resume_runs_on_the_cpu_as_the_reference(capsys):
    script = ("import sys\n"
              "for name in ('jax', 'jaxlib', 'dmlc_tpu', 'ml_dtypes'):\n"
              "    sys.modules[name] = None\n"
              "from dmlc_tpu_torch.examples import checkpoint_resume\n"
              "checkpoint_resume.main(['--device', 'cpu'])\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    _jax_example("checkpoint_resume").main()
    want = capsys.readouterr().out
    assert proc.stdout == want
    assert proc.stdout.splitlines()[-1] == "resumed stream matches the uninterrupted pass — OK"


def test_checkpoint_resume_on_a_registered_filesystem(capsys):
    import torch

    from dmlc_tpu_torch.utils.check import DMLCError

    MemoryFileSystem.reset()
    try:
        assert checkpoint_resume.run("mem://examples/train.libsvm", "cpu") == 16
        if not torch.cuda.is_available():  # the default device is the card
            with pytest.raises(DMLCError, match="device='cpu'"):
                checkpoint_resume.open_pipeline("mem://examples/train.libsvm", None)
    finally:
        MemoryFileSystem.reset()
    assert "resumed: 13 batches" in capsys.readouterr().out
