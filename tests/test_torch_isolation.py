"""The port stands alone: no file of pianobart_tpu_torch/, nor chip_smoke.py,
imports jax, flax, optax, msgpack or the JAX package, and the package
imports with those blocked."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pianobart_tpu", "msgpack")
FILES = sorted((ROOT / "pianobart_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import pianobart_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(' '.join(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 46
    # the serving path's MIDI modules, the demo and the CLI among them, and
    # the pretraining run's: datasets, native codec, tokenizer pipeline and
    # validators, runner, logging, preemption
    assert {f"pianobart_tpu_torch.{m}" for m in (
        "midi.events", "midi.parser", "midi.writer", "tokenizer.codec",
        "tokenizer.segment", "serve.app", "serve.demo", "cli",
        "data", "data.datasets", "midi.native", "tokenizer.pipeline",
        "tokenizer.validate", "train.state", "train.runner", "utils.logging",
        "utils.preemption", "merge", "merge.methods", "merge.cli",
        "compat.flax_msgpack", "utils.profiling")} <= mods
