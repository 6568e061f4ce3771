"""The port stands alone: no module of src/repro_torch/ and not
chip_smoke.py imports jax or the JAX package ``repro``, importing
``repro_torch`` leaves jax out of ``sys.modules``, and no module of
src/repro_torch/ names a path under src/repro/ in its code (a data file of
the reference, such as its planner profile, read through a path).  The
lint's modules that need only the standard library import nothing else."""
import ast
import os
import re
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

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
                "serve/httpd.py", "core/distributed.py", "launch/mesh.py",
                "configs/nucleus.py", "configs/moonshot_v1_16b_a3b.py",
                "configs/deepseek_v2_lite_16b.py", "distbuild/builder.py",
                "distbuild/exchange.py", "distbuild/planner.py",
                "optim/adamw.py", "checkpoint/manager.py", "data/pipeline.py",
                "distributed/runtime.py", "launch/train.py", "tree.py",
                "models/gnn_common.py", "models/din.py", "models/gin.py",
                "models/egnn.py", "models/dimenet.py", "models/mace.py",
                "configs/din.py", "configs/gnn_shapes.py",
                "configs/gin_tu.py", "configs/egnn.py", "configs/dimenet.py",
                "configs/mace.py", "graph/sampler.py", "graph/unionfind.py",
                "distributed/sharding.py", "launch/platform.py",
                "launch/dryrun.py", "tools/calibrate_planner.py",
                "tools/check_build_budget.py", "analysis/__init__.py",
                "analysis/__main__.py", "analysis/findings.py",
                "analysis/driver.py", "analysis/baseline.py",
                "analysis/deadmod.py", "analysis/torchast.py",
                "analysis/rules_trace.py", "analysis/rules_recompile.py",
                "analysis/rules_concurrency.py",
                "analysis/rules_registry.py", "examples/quickstart.py",
                "examples/approx_vs_exact.py", "examples/graph_pipeline.py",
                "examples/elastic_restart.py", "examples/serve_lm.py",
                "examples/train_lm.py"):
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
            "repro_torch.core.streaming, repro_torch.serve, "
            "repro_torch.core.distributed, repro_torch.launch.mesh, "
            "repro_torch.configs.nucleus, repro_torch.distbuild, "
            "repro_torch.configs.moonshot_v1_16b_a3b, "
            "repro_torch.configs.deepseek_v2_lite_16b, repro_torch.optim, "
            "repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.distributed, repro_torch.launch.train, "
            "repro_torch.models.din, repro_torch.models.gin, "
            "repro_torch.models.egnn, repro_torch.models.dimenet, "
            "repro_torch.models.mace, repro_torch.configs.gnn_shapes, "
            "repro_torch.graph.sampler, repro_torch.launch.steps, "
            "repro_torch.distributed.sharding, repro_torch.launch.platform, "
            "repro_torch.launch.dryrun, repro_torch.tools.calibrate_planner, "
            "repro_torch.tools.check_build_budget, repro_torch.analysis, "
            "repro_torch.analysis.__main__, repro_torch.examples.quickstart, "
            "repro_torch.examples.approx_vs_exact, "
            "repro_torch.examples.graph_pipeline, "
            "repro_torch.examples.elastic_restart, "
            "repro_torch.examples.serve_lm, repro_torch.examples.train_lm; "
            "bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; print(bad); "
            "assert not bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


STDLIB_ONLY = ("findings.py", "driver.py", "baseline.py", "deadmod.py",
               "torchast.py", "rules_trace.py", "rules_recompile.py",
               "rules_concurrency.py", "rules_registry.py", "__init__.py",
               "__main__.py")


@pytest.mark.parametrize("name", STDLIB_ONLY)
def test_lint_imports_only_the_standard_library(name):
    path = os.path.join(ROOT, "src", "repro_torch", "analysis", name)
    roots = set(imported_roots(path))
    assert roots <= set(sys.stdlib_module_names) | {"__future__"}, roots
