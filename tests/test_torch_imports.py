"""The port stands alone: no module of src/repro_torch/ and not
chip_smoke.py imports jax or the JAX package ``repro``, importing
``repro_torch`` leaves jax out of ``sys.modules``, and no module of
src/repro_torch/ names a path under src/repro/ in its code (a data file of
the reference, such as its planner profile, read through a path)."""
import ast
import os
import re
import subprocess
import sys

import pytest

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_found():
    files = port_files()
    assert len(files) > 15
    assert any(f.endswith("engine.py") for f in files)
    rel = {os.path.relpath(f, os.path.join(ROOT, "src", "repro_torch"))
           for f in files}
    for mod in ("models/transformer.py", "configs/minicpm_2b.py",
                "configs/minitron_4b.py", "configs/stablelm_12b.py",
                "launch/serve.py", "launch/steps.py",
                "kernels/flash_attention.py", "core/session.py",
                "core/streaming.py", "serve/__init__.py", "serve/router.py",
                "serve/frontend.py", "serve/status.py", "serve/cache.py",
                "serve/httpd.py"):
        assert mod in rel, mod


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


# a path component "repro" (the reference package's directory)
REFERENCE_PATH = re.compile(r"(^|[/\\])repro([/\\]|$)")


def reference_paths(source):
    """(line, string) of every string constant outside docstrings that
    names a path under the reference package: "repro" as a path part or
    as a component handed to os.path.join."""
    tree = ast.parse(source)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs and REFERENCE_PATH.search(node.value)]


def test_reference_path_detector():
    """The scan below sees a path into the reference however it is
    spelled, and passes the port's own paths and docstrings."""
    bad = ('"""Reads src/repro/core/planner_profile.json."""\n'
           'import os\n'
           'A = os.path.join(ROOT, "src", "repro", "core")\n'
           'B = "../repro/core/planner_profile.json"\n'
           'C = "src\\\\repro\\\\core"\n'
           'D = os.path.join(ROOT, "src", "repro_torch", "core")\n'
           'E = "repro_torch/core/planner_profile.json"\n')
    assert sorted(line for line, _ in reference_paths(bad)) == [3, 4, 5]


@pytest.mark.parametrize(
    "path", [p for p in port_files() if not p.endswith("chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_path_into_the_reference(path):
    with open(path) as f:
        found = reference_paths(f.read())
    assert not found, f"{os.path.relpath(path, ROOT)} names {found}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels."
            "peel_round, repro_torch.kernels.segment_sum, repro_torch.graph."
            "generators, repro_torch.kernels.flash_attention, "
            "repro_torch.models, repro_torch.configs, repro_torch.launch, "
            "repro_torch.launch.serve, repro_torch.core.session, "
            "repro_torch.core.streaming, repro_torch.serve; bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; print(bad); "
            "assert not bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
