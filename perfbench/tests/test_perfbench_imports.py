"""Nothing a run loads is JAX, Flax or the JAX package, and the reference
loads nothing of the program either: top-level module names compared
whole (pocomc_tpu_torch begins with pocomc_tpu and is not it)."""

import ast
import json
import subprocess
import sys
import types

from conftest import ROOT
from perfbench import harness

JAX_SIDE = {"jax", "jaxlib", "flax", "pocomc_tpu"}


def _top_levels(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_levels(
        "import sys, json; sys.path[:0] = ['perfbench/tests', '.']\n"
        "from conftest import run_tiny\n"
        "for cell in ('gauss50.smc', 'rosen50_nsfc12.sweep'):\n"
        "    assert run_tiny(cell, seconds=1.0, trace=True)['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "pocomc_tpu_torch" in names
    assert not names & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    names = _top_levels(
        "import sys, json, importlib, importlib.util, pathlib; sys.path.insert(0, '.')\n"
        "for m in ('flows', 'smc', 'check', 'problems', 'precision', 'train'):\n"
        "    importlib.import_module('perfbench.reference.' + m)\n"
        "for p in sorted(pathlib.Path('perfbench/configs').glob('*.py')):\n"
        "    spec = importlib.util.spec_from_file_location(p.stem, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & (JAX_SIDE | {"pocomc_tpu_torch"})


def test_the_reference_sources_import_nothing_of_the_program():
    files = list((ROOT / "perfbench" / "reference").glob("*.py"))
    files += list((ROOT / "perfbench" / "configs").glob("*.py"))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert not tops & (JAX_SIDE | {"pocomc_tpu_torch"}), (path, tops)


def test_the_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pocomc_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlibrary", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pocomc_tpu.sampler", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["pocomc_tpu"]
