"""The port does all that the JAX package does: every public top-level name
of every ``src/repro/**.py`` and every ``examples/*.py`` has a counterpart
in ``src/repro_torch/``.

A reference name is covered when the mirrored port module (the same path
under ``src/repro_torch/``) binds the same name, by a definition or an
import, or when ``COUNTERPARTS`` maps it: to the port's module and name it
is ported as, or to the one-line reason it has no counterpart (TPU and
JAX machinery the port replaces with something of another shape).  Both
packages are read by AST only; nothing of the reference is imported.  A
map entry that no longer names a reference name, or whose port name is
gone, fails too, so the map stays the record of what is reference-only.
"""
import ast
import os

import pytest

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")

_PALLAS_TILE = ("a Pallas tile size; the CUDA kernel in kernels/csrc picks "
                "its own blocks")
_SHARD_MAP_PAD = ("shard_map padding of the incidence arrays to equal "
                  "shards; the port's slabs are unpadded "
                  "(core/distributed.py)")
_HLO = ("reads the lowered XLA HLO; the port's dry run counts on meta "
        "tensors and reckons transfers from the specs")

# reference "path:name" (or a whole module "path") -> the port's
# (path, name) it is ported as, or the reason there is no counterpart
COUNTERPARTS = {
    "graph/cliques.py:sort_join_np": ("graph/cliques.py", "sort_join"),
    "kernels/ops.py:segment_sum": ("kernels/segment_sum.py", "segment_sum"),
    "kernels/segment_sum.py:segment_sum_sorted":
        ("kernels/segment_sum.py", "segment_sum"),
    "core/engine.py:pallas_by_default":
        ("core/engine.py", "kernel_by_default"),
    "core/planner_profile.py:pallas_default":
        ("core/planner_profile.py", "kernel_default"),
    "core/backends.py:KNOBS": ("core/backends.py", "_KNOB_RULES"),
    "core/__init__.py:sharded_decomposition":
        ("core/distributed.py", "sharded_decomposition"),
    "launch/dryrun.py:lower_cell": ("launch/dryrun.py", "run_cell"),
    "analysis/jaxast.py": ("analysis/torchast.py", "hot_regions"),
    "kernels/flash_attention.py:DEFAULT_BLOCK_Q": _PALLAS_TILE,
    "kernels/flash_attention.py:DEFAULT_BLOCK_K": _PALLAS_TILE,
    "kernels/flash_attention.py:NEG_INF":
        "the Pallas body's mask value; the CUDA kernel masks in registers",
    "kernels/peel_round.py:peel_round_plan":
        "the Pallas grid's padded windows; peel_round.cu lays the live "
        "r-cliques' edges end to end by a scan",
    "kernels/peel_round.py:chunk_windows":
        "the Pallas grid's padded windows; peel_round.cu lays the live "
        "r-cliques' edges end to end by a scan",
    "kernels/segment_sum.py:DEFAULT_BLOCK_N": _PALLAS_TILE,
    "kernels/segment_sum.py:DEFAULT_CHUNK_E": _PALLAS_TILE,
    "kernels/segment_sum.py:sorted_ids_plan":
        "the Pallas grid's chunk plan; segment_sum.cu scans flat tiles",
    "kernels/tricount.py:TILE": _PALLAS_TILE,
    "configs/base.py:sds":
        "jax.ShapeDtypeStruct; the port gives shapes by init_params(..., "
        "device='meta')",
    "distributed/sharding.py:constrain":
        "jax.lax.with_sharding_constraint, a GSPMD hint; the port places "
        "ShardedTensors itself",
    "core/__init__.py:DEPRECATED_NAMES":
        "the deprecation shims; the port exports the functions plainly",
    "core/engine.py:ScatterSpec":
        "the jitted Pallas scatter path's static config; the port's "
        "wrappers take plain arguments",
    "core/distributed.py:pad_incidence": _SHARD_MAP_PAD,
    "core/distributed.py:make_sharded_decomposition": _SHARD_MAP_PAD,
    "core/distributed.py:sharded_decomposition_padded": _SHARD_MAP_PAD,
    "core/distributed.py:dryrun_specs":
        "shard_map in/out specs for an XLA lowering; the port does not lower",
    "launch/dryrun.py:COLLECTIVE_RE": _HLO,
    "launch/dryrun.py:SHAPE_RE": _HLO,
    "launch/dryrun.py:collective_bytes": _HLO,
    "launch/platform.py:GPU_XLA_FLAGS":
        "XLA flags; setup_platform raises on them (torch has none)",
}


def top_level(path):
    """(defined names, imported names) of a module's top level."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    defined, imported = [], set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defined.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                defined += [e.id for e in elts if isinstance(e, ast.Name)]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0]
                         for a in node.names}
    return defined, imported


def public_names(path):
    """The public names a module defines at its top level."""
    return [n for n in top_level(path)[0] if not n.startswith("_")]


def bound_names(path):
    """Every name of a module's namespace: its top-level definitions and
    imports."""
    defined, imported = top_level(path)
    return set(defined) | imported


def reference_modules():
    out = []
    for dirpath, _, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(dirpath, f), REF)
                for f in files if f.endswith(".py")]
    return sorted(out)


def port_has(rel, name, port=PORT):
    path = os.path.join(port, rel)
    return os.path.exists(path) and name in bound_names(path)


def uncovered(rel, ref=REF, port=PORT, counterparts=COUNTERPARTS):
    """The public names of reference module ``rel`` that the port neither
    binds nor maps."""
    if rel in counterparts:
        return []
    return [n for n in public_names(os.path.join(ref, rel))
            if not port_has(rel, n, port)
            and f"{rel}:{n}" not in counterparts]


@pytest.mark.parametrize("rel", reference_modules())
def test_every_reference_name_has_a_counterpart(rel):
    assert not uncovered(rel), (
        f"src/repro/{rel}: {uncovered(rel)} have no counterpart in "
        f"src/repro_torch/{rel}; port them or map them in COUNTERPARTS")


def test_the_map_names_live_reference_names_and_port_names():
    for key, value in COUNTERPARTS.items():
        rel, _, name = key.partition(":")
        assert os.path.exists(os.path.join(REF, rel)), key
        if name:
            assert name in public_names(os.path.join(REF, rel)), key
            assert not port_has(rel, name), f"{key} is ported by its name"
        if isinstance(value, tuple):
            assert port_has(*value), f"{key} -> {value}: not in the port"
        else:
            assert value.strip(), f"{key}: no reason given"


def test_the_checker_sees_a_gap(tmp_path):
    """On two small trees: a reference name the port lacks is reported;
    one it defines or imports, or one the map names, is not; a module the
    port lacks reports all its public names."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    for d in (ref / "pkg", port / "pkg"):
        d.mkdir(parents=True)
    src = ref / "pkg" / "mod.py"
    src.write_text("import os\nA = 1\ndef f():\n    pass\n_g = 2\n"
                   "class C:\n    x = 3\n")
    (ref / "pkg" / "gone.py").write_text("B = 1\n_h = 2\n")
    (port / "pkg" / "mod.py").write_text("from .other import f\nA = 2\n")
    assert public_names(str(src)) == ["A", "f", "C"]
    assert bound_names(str(src)) == {"os", "A", "f", "C", "_g"}
    kw = dict(ref=str(ref), port=str(port), counterparts={})
    assert uncovered("pkg/mod.py", **kw) == ["C"]
    assert uncovered("pkg/gone.py", **kw) == ["B"]
    kw["counterparts"] = {"pkg/mod.py:C": "a reason",
                          "pkg/gone.py": "a reason"}
    assert uncovered("pkg/mod.py", **kw) == []
    assert uncovered("pkg/gone.py", **kw) == []


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(ROOT, "examples"))
    if f.endswith(".py")))
def test_every_example_has_a_port_entry_point(name):
    path = os.path.join(PORT, "examples", name)
    assert os.path.exists(path), f"examples/{name} has no port counterpart"
    assert "main" in public_names(path)
    with open(path) as f:
        assert 'if __name__ == "__main__":' in f.read()
