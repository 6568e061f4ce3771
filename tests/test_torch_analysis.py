"""repro_torch.analysis, the port's lint: every rule fires on its fixture
and stays quiet on the clean twin; NL301/NL302 match ``repro.analysis``
on the reference's serve fixture; suppressions, the baseline, the CLI and
the dead-module report; and src/repro_torch is clean modulo the committed
``.nucleuslint-torch-baseline.json``.

The fixtures are inline sources written into ``tmp_path`` under the path
each rule is pinned to (``core/session.py``, ``serve/frontend.py``).
"""
import json
import os
import textwrap

import pytest

import repro.analysis as J

from repro_torch.analysis import (apply_baseline, dead_module_report,
                                  load_baseline, load_project, run_analysis,
                                  write_baseline)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.baseline import BASELINE_FORMAT, DEFAULT_BASELINE
from repro_torch.analysis.driver import rule_catalog

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rule -> (path in the fixture tree, source that fires, its clean twin)
FIXTURES = {
    "NL101": ("core/loop.py", """
        import torch

        def peel(deg: torch.Tensor, n: int):
            for _ in range(n):
                m = int(deg.min())
                deg = deg - m
            return deg
        """, """
        import torch

        def peel(deg: torch.Tensor, n: int):
            m = int(deg.min())
            for _ in range(n):
                deg = deg - deg.shape[0]
            return deg - m
        """),
    "NL102": ("core/loop.py", """
        import torch

        def run(x: torch.Tensor):
            while True:
                x = x - 1
                if (x < 0).any():
                    break
            return x
        """, """
        import torch

        def run(x: torch.Tensor, n: int):
            while n > 0:
                x = torch.where(x > 0, x - 1, x)
                if x.ndim > 1 and x is not None:
                    n -= 1
                n -= 1
            return x
        """),
    "NL103": ("models/block.py", """
        import torch
        from torch.utils.checkpoint import checkpoint

        def layer(x, w):
            if x.sum() > 0:
                x = x * 2
            return x @ w

        def trunk(x, w):
            return checkpoint(layer, x, w, use_reentrant=False)
        """, """
        import torch
        from torch.utils.checkpoint import checkpoint

        def layer(x, w):
            return torch.where(x > 0, x * 2, x) @ w

        def trunk(x, w):
            return checkpoint(layer, x, w, use_reentrant=False)
        """),
    "NL201": ("kernels/build.py", """
        import ctypes

        def library(path):
            return ctypes.CDLL(path)
        """, """
        import ctypes
        import functools

        @functools.lru_cache(maxsize=None)
        def library(path):
            return ctypes.CDLL(path)
        """),
    "NL202": ("core/session.py", """
        import time

        def bucket_key(n_r, n_s):
            return (n_r, n_s, time.time())
        """, """
        def bucket_key(n_r, n_s):
            return (1 << (n_r - 1).bit_length(), n_s)
        """),
    "NL301": ("serve/pool.py", """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self.stats = {}

            def count(self, k):
                with self._lock:
                    self.stats[k] = self.stats.get(k, 0) + 1

            def reset(self):
                self.stats.clear()
        """, """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self.stats = {}

            def count(self, k):
                with self._lock:
                    self.stats[k] = self.stats.get(k, 0) + 1

            def reset(self):
                with self._lock:
                    self.stats.clear()
        """),
    "NL302": ("serve/frontend.py", """
        class Frontend:
            def submit(self, request):
                return self.router.route_many([request])

            def _run(self):
                self.router.route_many([])
        """, """
        class Frontend:
            def submit(self, request):
                self._queue.put(request)

            def _run(self):
                self.router.route_many([])
        """),
    "NL401": ("core/backends.py", """
        def _run_dense(problem, config):
            return config.use_kernel

        register(_Registered(
            name="dense",
            capabilities=BackendCapabilities(knobs=frozenset()),
            _run=_run_dense))
        """, """
        def _run_dense(problem, config):
            return config.use_kernel

        register(_Registered(
            name="dense",
            capabilities=BackendCapabilities(knobs=frozenset({"pallas"})),
            _run=_run_dense))
        """),
}


def lint(tmp_path, rel, source, only=None):
    path = tmp_path / "pkg" / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return run_analysis(load_project([str(tmp_path / "pkg")],
                                     root=str(tmp_path)), only=only)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_on_its_fixture_and_not_on_the_twin(tmp_path, rule):
    rel, bad, clean = FIXTURES[rule]
    got = lint(tmp_path / "bad", rel, bad)
    assert [f.rule for f in got] == [rule], [f.render() for f in got]
    assert got[0].path == f"pkg/{rel}"
    assert lint(tmp_path / "clean", rel, clean) == []


def test_catalog_lists_every_rule_once():
    ids = [r for r, _ in rule_catalog()]
    assert ids == sorted(FIXTURES) and len(set(ids)) == len(ids)


def test_sync_rules_see_function_bodies_and_graph_captures(tmp_path):
    src = """
        import torch

        class Clip(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.clamp(max=float(x.max()))

        def replay(x: torch.Tensor, graph_pool):
            with torch.cuda.graph(graph_pool):
                y = x.nonzero()
            return y
        """
    got = [(f.rule, f.line) for f in lint(tmp_path, "m.py", src)]
    assert got == [("NL103", 7), ("NL101", 11)]


def test_nl301_nl302_match_the_reference_on_its_serve_fixture():
    fixture = os.path.join(ROOT, "tests", "analysis_fixtures", "serve",
                           "frontend.py")

    def findings(pkg):
        proj = pkg.load_project([fixture], root=ROOT)
        return [(f.rule, f.line)
                for f in pkg.run_analysis(proj, only=["NL3"])]
    want = findings(J)
    assert {r for r, _ in want} == {"NL301", "NL302"}
    assert findings(__import__("repro_torch.analysis").analysis) == want


def test_suppressions(tmp_path):
    src = """
        import torch

        def peel(deg: torch.Tensor, n: int):
            for _ in range(n):
                a = int(deg.min())  # nucleuslint: disable=NL101 (why)
                # nucleuslint: disable=all
                b = int(deg.max())
                c = int(deg.sum())  # nucleuslint: disable=NL102
            return a + b + c
        """
    got = lint(tmp_path, "m.py", src)
    assert [(f.rule, f.line) for f in got] == [("NL101", 9)]


def test_baseline_round_trip(tmp_path):
    src = FIXTURES["NL101"][1]
    found = lint(tmp_path, "core/loop.py", src)
    path = str(tmp_path / "baseline.json")
    write_baseline(found + found, path)
    with open(path) as f:
        blob = json.load(f)
    assert blob["format"] == BASELINE_FORMAT
    assert blob["findings"][0]["count"] == 2
    new, stale = apply_baseline(found, load_baseline(path))
    assert new == [] and len(stale) == 1           # one slot left over
    new, stale = apply_baseline(found * 3, load_baseline(path))
    assert len(new) == 1 and stale == []
    assert load_baseline(str(tmp_path / "missing.json")) == {}


@pytest.fixture(scope="module")
def port_findings():
    return run_analysis(load_project(
        [os.path.join(ROOT, "src", "repro_torch")], root=ROOT))


def test_port_is_clean_modulo_the_committed_baseline(port_findings):
    assert DEFAULT_BASELINE == ".nucleuslint-torch-baseline.json"
    new, stale = apply_baseline(
        port_findings, load_baseline(os.path.join(ROOT, DEFAULT_BASELINE)))
    assert new == [] and stale == [], [f.render() for f in new] + stale
    # the engine's one sync a round is suppressed inline, not baselined
    assert not any(f.path.endswith("core/engine.py") and
                   "int() of a tensor in a while loop" == f.message
                   for f in port_findings)


def test_cli_agrees_with_the_library(tmp_path, monkeypatch, capsys,
                                     port_findings):
    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "lint.json")
    assert cli.main(["src/repro_torch", "--json", out]) == 0
    with open(out) as f:
        blob = json.load(f)
    assert blob["all_findings"] == [f.to_dict() for f in port_findings]
    assert blob["n_new"] == 0 and blob["n_baselined"] == len(port_findings)
    bad = tmp_path / "core" / "loop.py"
    bad.parent.mkdir()
    bad.write_text(textwrap.dedent(FIXTURES["NL101"][1]))
    assert cli.main([str(bad), "--no-baseline"]) == 1
    assert cli.main([str(bad), "--no-baseline", "--only", "NL3"]) == 0
    assert cli.main(["--list-rules"]) == 0
    assert "NL401" in capsys.readouterr().out


def test_dead_report_has_the_reference_shape(monkeypatch, tmp_path):
    monkeypatch.chdir(ROOT)
    mine = dead_module_report()
    # the reference's report on a two-module tree of its own package
    pkg = tmp_path / "src" / "repro" / "core"
    pkg.mkdir(parents=True)
    (pkg.parent / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("from . import engine\n")
    (pkg / "engine.py").write_text("")
    ref = J.dead_module_report(src_root=str(tmp_path / "src"),
                               extra_root_dirs=())
    assert sorted(mine) == sorted(ref)
    assert all(type(mine[k]) is type(ref[k]) for k in ref)
    assert mine["n_modules"] > 90 and "repro_torch.core.engine" in \
        mine["roots"]
    assert all(m.startswith("repro_torch") for m in mine["roots"])
    # the tests keep the lint itself alive
    assert not any(m.startswith("repro_torch.analysis")
                   for m in mine["dead"])
