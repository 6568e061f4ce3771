"""The port's GNN family (``repro_torch.models`` gin, egnn, dimenet, mace
and ``gnn_common``; ``launch.steps``' ``gnn_loss`` and ``gnn_train_step``;
the neighbour sampler, the graph streams and the union-find helpers)
against the reference, on the CPU.

The same numpy inputs go through both: parameters drawn with numpy at the
reference's names, shapes and dtypes (``jax.eval_shape`` of its
``init_params``, so its init is never compiled), carried across by
``tree.params_from_reference``.  The reference's losses and steps are
jitted once per config, arch and level.  Integer arrays (triplets,
sampled blocks, streams, molecules, union-find) must be bit-identical;
floats are float32 at the smoke widths, with the tolerances stated per
test.
"""
import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph.generators as jgenerators
from repro.configs import get_arch as j_get_arch
from repro.data import GraphMinibatchStream as JStream
from repro.data import synthetic_molecules as j_molecules
from repro.graph import BatchedUnionFind as JUnionFind
from repro.graph import NeighborSampler as JSampler
from repro.graph import container as jcontainer
from repro.graph import uf_find_all as j_find_all
from repro.launch import dryrun as jdryrun
from repro.launch import steps as JS
from repro.models import gnn_common as JG
from repro.optim import adamw as JA
from repro_torch.configs import get_arch
from repro_torch.configs.gnn_shapes import (GNN_SHAPES, cfg_for_cell,
                                            needs_pos, needs_triplets)
from repro_torch.data import GraphMinibatchStream, synthetic_molecules
from repro_torch.graph import (BatchedUnionFind, NeighborSampler, is_member,
                               make_graph, orient, uf_create, uf_find_all)
from repro_torch.graph.orientation import degree_rank
from repro_torch.launch import steps as S
from repro_torch.models import dimenet, egnn, gin, mace
from repro_torch.models.gnn_common import (build_triplets,
                                           make_batch_from_arrays)
from repro_torch.optim import adamw as A
from repro_torch.tree import flatten_with_paths, params_from_reference

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

GNN_ARCHS = ("dimenet", "egnn", "gin-tu", "mace")
J_OPT = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
OPT = A.AdamWConfig(**dataclasses.asdict(J_OPT))


def t(a):
    return torch.from_numpy(np.asarray(a))


def j_params(arch, jc, seed=0):
    """numpy parameters at the reference's names, shapes and dtypes:
    N(0, 1/fan_in) matrices, N(0, 0.1^2) vectors and scalars (non-zero
    biases and eps, so every term of the models is exercised)."""
    shapes = jax.eval_shape(functools.partial(JS._GNN[arch].init_params,
                                              cfg=jc), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1.0 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.1
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return jax.tree.map(draw, shapes)


def pair(arch, node_level):
    """(reference config, port config) at the smoke widths, with three
    classes and a node-level head where the task is per node."""
    jc = j_get_arch(arch).make_smoke_config()
    tc = get_arch(arch).make_smoke_config()
    kw = {}
    if node_level:
        kw = ({"n_classes": 3, "graph_level": False} if arch == "gin-tu"
              else {"n_out": 3})
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def node_batch(arch, d_in, N=40, E=120, seed=0):
    """A node task: random edges (self-loops included), four masked edges,
    two padding nodes, labels on half the nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    batch = {
        "nodes": rng.standard_normal((N, d_in)).astype(np.float32),
        "edge_src": src, "edge_dst": dst,
        "node_mask": np.arange(N) < N - 2,
        "edge_mask": ~np.isin(np.arange(E), [3, 50, 51, 119]),
        "graph_id": np.arange(N, dtype=np.int32),
        "labels": rng.integers(0, 3, N).astype(np.int32),
        "label_mask": (rng.random(N) < 0.5).astype(np.float32),
    }
    if needs_pos(arch):
        batch["pos"] = rng.standard_normal((N, 3)).astype(np.float32)
    if needs_triplets(arch):
        kj, ji, m = JG.build_triplets(src, dst, N, cap_per_edge=4)
        m = m.copy()
        m[::7] = False
        batch.update(triplet_kj=kj, triplet_ji=ji, triplet_mask=m)
    return batch, N


def molecule_batch(arch, d_in, seed=1):
    m = j_molecules(4, 8, 16, d_in, seed=seed, triplet_cap=4)
    batch = {
        "nodes": m["nodes"], "edge_src": m["edge_src"],
        "edge_dst": m["edge_dst"],
        "node_mask": np.ones(m["nodes"].shape[0], bool),
        "edge_mask": np.ones(m["edge_src"].shape[0], bool),
        "graph_id": m["graph_id"], "energy": m["energy"][:, None],
    }
    if needs_pos(arch):
        batch["pos"] = m["pos"]
    if needs_triplets(arch):
        kj, ji, msk = m["triplets"]
        batch.update(triplet_kj=kj, triplet_ji=ji, triplet_mask=msk)
    return batch, m["n_graphs"]


def case(arch, node_level):
    jc, tc = pair(arch, node_level)
    batch, n_graphs = (node_batch(arch, jc.d_in) if node_level
                       else molecule_batch(arch, jc.d_in))
    jp = j_params(arch, jc)
    return jc, tc, batch, n_graphs, jp, params_from_reference(jp, "cpu")


def on_torch(b):
    return {k: t(v) for k, v in b.items()}


def on_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# the reference compiled once per config, arch and level: its loss, the
# gradient and the forward outputs in one program; its step is that
# gradient and ``apply_updates`` (``repro.launch.steps.gnn_train_step``)
@functools.lru_cache(maxsize=None)
def j_reference(jc, arch, n_graphs, node_level):
    loss_grad = jax.value_and_grad(functools.partial(
        JS.gnn_loss, cfg=jc, arch=arch, n_graphs=n_graphs,
        node_level=node_level))

    def run(p, b):
        loss, grads = loss_grad(p, b)
        out = JS._GNN[arch].forward(p, JS._rebatch(b, n_graphs), jc)
        return loss, grads, out
    return jax.jit(run)


j_apply_updates = jax.jit(JA.apply_updates, static_argnums=3)


def assert_tree_close(got, want, rtol, atol, what):
    g = dict(flatten_with_paths(got))
    w = dict(flatten_with_paths(jax.device_get(want)))
    assert sorted(g) == sorted(w), what
    for k, a in w.items():
        np.testing.assert_allclose(g[k].detach().numpy(), np.asarray(a),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_configs_and_cells_match_reference(arch):
    """Full and smoke configs field for field (dtype aside), the four
    cells' dims, and ``cfg_for_cell`` equal to the reference's per-cell
    rule on every cell."""
    jspec, spec = j_get_arch(arch), get_arch(arch)
    assert spec.family == jspec.family == "gnn"
    for which in ("make_config", "make_smoke_config"):
        jc, tc = getattr(jspec, which)(), getattr(spec, which)()
        assert {k: v for k, v in jc.__dict__.items() if k != "dtype"} == \
            {k: v for k, v in tc.__dict__.items() if k != "dtype"}
        assert tc.dtype == torch.float32
    assert [(c.name, c.kind, c.dims) for c in spec.shapes] == \
        [(c.name, c.kind, c.dims) for c in jspec.shapes]
    for jcell, cell in zip(jspec.shapes, GNN_SHAPES):
        want = jdryrun._gnn_cfg_for_cell(jspec, jcell)
        got = cfg_for_cell(spec, cell)
        assert {k: v for k, v in want.__dict__.items() if k != "dtype"} == \
            {k: v for k, v in got.__dict__.items() if k != "dtype"}


# ---------------------------------------------------------------------------
# integer arrays: bit-identical
# ---------------------------------------------------------------------------

def _edges(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":       # self-loops, repeats, isolated nodes
        return rng.integers(0, 30, (2, 200)), 40
    if kind == "star":         # one hub: many candidates per out-edge
        hub = np.zeros(60, np.int64)
        leaves = np.arange(1, 61)
        return np.stack([np.r_[hub, leaves], np.r_[leaves, hub]]), 61
    m = j_molecules(3, 10, 24, 4, seed=seed)
    return np.stack([m["edge_src"], m["edge_dst"]]), 30


@pytest.mark.parametrize("kind", ["random", "star", "molecule"])
@pytest.mark.parametrize("cap", [None, 1, 4])
def test_build_triplets_bit_identical(kind, cap):
    (src, dst), n = _edges(kind, 3)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    want = JG.build_triplets(src, dst, n, cap_per_edge=cap)
    got = build_triplets(src, dst, n, cap_per_edge=cap)
    assert want[0].shape[0] > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_build_triplets_empty():
    e = np.zeros(0, np.int32)
    for g, w in zip(build_triplets(e, e, 5, 4), JG.build_triplets(e, e, 5,
                                                                   4)):
        assert g.dtype == w.dtype and g.shape == w.shape == (0,)


def _ba(n=500, k=5, seed=0):
    jg = jgenerators.barabasi_albert(n, k, seed=seed)
    return jg, make_graph(jg.n, np.asarray(jg.edges), device="cpu")


def test_sampler_blocks_bit_identical():
    """Three blocks in a row from one sampler (the rng advances), seeds
    with repeats among them: every array of every block equal."""
    jg, g = _ba()
    js, ts = JSampler(jg, [4, 3], seed=5), NeighborSampler(g, [4, 3], seed=5)
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    np.testing.assert_array_equal(ts.dst, js.dst)
    assert NeighborSampler.capacities(16, [4, 3]) == \
        JSampler.capacities(16, [4, 3])
    rng = np.random.default_rng(0)
    for i in range(3):
        seeds = rng.integers(0, jg.n, 16)
        seeds[3] = seeds[9]                       # a repeated seed
        want, got = js.sample(seeds), ts.sample(seeds)
        for f in ("node_ids", "edge_src", "edge_dst"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f"block {i} {f}")
        for f in ("n_nodes", "n_edges", "seed_count"):
            assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("with_pos", [False, True])
def test_graph_minibatch_stream_bit_identical(with_pos):
    jg, g = _ba(300, 4, seed=2)
    kw = dict(fanouts=[3, 2], batch_nodes=8, d_feat=5, n_classes=3, seed=1,
              with_pos=with_pos)
    js, ts = JStream(jg, **kw), GraphMinibatchStream(g, **kw)
    assert (ts.cap_nodes, ts.cap_edges) == (js.cap_nodes, js.cap_edges)
    for step in (0, 1):
        want, got = js.batch(step), ts.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n_e = int(got["edge_mask"].sum())
        assert got["edge_src"][:n_e].max() < int(got["node_mask"].sum())


@pytest.mark.parametrize("cap", [None, 8])
def test_synthetic_molecules_bit_identical(cap):
    """At the molecule cell's 30 nodes and 64 edges a molecule has
    k = 64 // 30 = 2 out-edges a node: 60 edges, as in the reference."""
    want = j_molecules(5, 30, 64, 16, seed=4, triplet_cap=cap)
    got = synthetic_molecules(5, 30, 64, 16, seed=4, triplet_cap=cap)
    assert sorted(got) == sorted(want)
    assert got["edge_src"].shape == (5 * 60,)
    for k in want:
        if k == "triplets":
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(g, w)
        elif k == "n_graphs":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_union_find_bit_identical():
    """``uf_find_all`` of a random forest (parent[i] <= i) and
    ``BatchedUnionFind``'s two rounds of unions equal the reference's."""
    rng = np.random.default_rng(0)
    n = 300
    parent = np.array([rng.integers(0, i + 1) for i in range(n)], np.int32)
    np.testing.assert_array_equal(
        uf_find_all(t(parent)).numpy(),
        np.asarray(j_find_all(jnp.asarray(parent))))
    np.testing.assert_array_equal(uf_create(n, device="cpu").numpy(),
                                  np.arange(n, dtype=np.int32))
    juf, tuf = JUnionFind.create(n), BatchedUnionFind.create(n,
                                                             device="cpu")
    for _ in range(2):
        u = rng.integers(0, n, 120).astype(np.int32)
        v = rng.integers(0, n, 120).astype(np.int32)
        want = juf.union_edges(jnp.asarray(u), jnp.asarray(v))
        got = tuf.union_edges(t(u), t(v))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tuf.find_all().numpy(),
                                  np.asarray(juf.find_all()))


def test_is_member_bit_identical():
    """On the port's DAG of a BA graph, handed to the reference as its own
    ``Digraph`` (its eager orient compiles op by op)."""
    _, g = _ba(200, 4, seed=1)
    dg = orient(g, degree_rank(g))
    jdg = jcontainer.Digraph(n=dg.n, **{
        f: jnp.asarray(getattr(dg, f).numpy())
        for f in ("offsets", "neighbors", "adj", "outdeg")})
    rng = np.random.default_rng(2)
    row = rng.integers(0, g.n, 2000).astype(np.int32)
    query = rng.integers(0, g.n, 2000).astype(np.int32)
    query[:500] = dg.adj.numpy()[row[:500], 0]     # some true members
    want = np.asarray(jcontainer.is_member(jdg, jnp.asarray(row),
                                           jnp.asarray(query)))
    got = is_member(dg, t(row), t(query)).numpy()
    assert want.sum() > 400
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the models and steps: allclose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_matches_reference(arch):
    """``forward`` on the molecule batch: graph outputs at rtol 1e-5 (and
    egnn's coordinates, mace's irreps)."""
    jc, tc, batch, n_graphs, jp, tp = case(arch, node_level=False)
    want = j_reference(jc, arch, n_graphs, False)(jp, on_jax(batch))[2]
    got = getattr(S._GNN[arch], "forward")(
        tp, S._rebatch(on_torch(batch), n_graphs), tc)
    if arch in ("egnn", "mace"):
        (want, want_x), (got, got_x) = want, got
        if arch == "egnn":
            want_x, got_x = {"x": want_x}, {"x": got_x}
        for k in want_x:
            np.testing.assert_allclose(got_x[k].numpy(),
                                       np.asarray(want_x[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert got.shape == want.shape and got.shape[0] == n_graphs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("node_level", [True, False],
                         ids=["node", "molecule"])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_loss_and_gradient_match_reference(arch, node_level):
    """``gnn_loss`` at rtol 1e-5 and every gradient leaf at rtol 1e-4 and
    an atol of 1e-5 of the leaf's largest entry (float32 sums in another
    order than XLA's cancel in the small entries); the node task has
    masked edges, nodes, triplets and labels.  A leaf the loss does not
    reach has a zero gradient on both sides."""
    jc, tc, batch, n_graphs, jp, tp = case(arch, node_level)
    jl, jg, _ = j_reference(jc, arch, n_graphs, node_level)(jp,
                                                           on_jax(batch))
    loss, grads = S.value_and_grad(S.gnn_loss, tp, on_torch(batch), tc,
                                   arch, n_graphs, node_level)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got = dict(zip([k for k, _ in flatten_with_paths(tp)], grads))
    want = dict(flatten_with_paths(jax.device_get(jg)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("node_level", [True, False],
                         ids=["node", "molecule"])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_train_step_matches_reference(arch, node_level):
    """One ``gnn_train_step``: loss at rtol 1e-5, grad_norm and lr, the
    moments, and the params with atol lr/1000.  An entry whose gradient is
    within 100·eps of zero (mace's node task has one at 1.4e-8) steps in a
    direction set by float32 rounding, g / (|g| + eps), so those entries
    are held to one step's size, lr."""
    jc, tc, batch, n_graphs, jp, tp = case(arch, node_level)
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), jp)
    jstate = JA.AdamWState(step=np.zeros((), np.int32), mu=zeros,
                           nu=jax.tree.map(np.copy, zeros))
    jl, jg, _ = j_reference(jc, arch, n_graphs, node_level)(jp,
                                                           on_jax(batch))
    jp2, js2, jm = j_apply_updates(jp, jg, jstate, J_OPT)
    tp2, ts2, tm = S.gnn_train_step(tp, A.init_state(tp), on_torch(batch),
                                    tc, arch, n_graphs, node_level, OPT)
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(ts2.step) == int(js2.step) == 1
    assert_tree_close(ts2.mu, js2.mu, 1e-4, 1e-8, "mu")
    assert_tree_close(ts2.nu, js2.nu, 1e-3, 1e-12, "nu")
    noise = {k: np.abs(np.asarray(m)) < (1 - J_OPT.b1) * 100 * J_OPT.eps
             for k, m in flatten_with_paths(jax.device_get(js2.mu))}
    for k, w in flatten_with_paths(jax.device_get(jp2)):
        got, w = dict(flatten_with_paths(tp2))[k].numpy(), np.asarray(w)
        np.testing.assert_allclose(got[~noise[k]], w[~noise[k]], rtol=0,
                                   atol=J_OPT.lr / 1000, err_msg=k)
        np.testing.assert_allclose(got[noise[k]], w[noise[k]], rtol=0,
                                   atol=J_OPT.lr, err_msg=k)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The repo's chip script as a module (importing it runs nothing)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "arch,layers,node_level",
    [(a, None, nl) for a in GNN_ARCHS for nl in (True, False)] +
    [("mace", 2, False)],
    ids=lambda v: {True: "node", False: "molecule", None: "smoke"}.get(
        v, str(v)))
def test_unreached_leaves_match_reference(arch, layers, node_level):
    """The leaves whose gradient the reference gives as all zero are
    exactly ``chip_smoke.gnn_unreached``'s: its full-width GNN steps
    demand a zero gradient there and a change of every other leaf.  The
    smoke mace has one layer, so a 2-layer mace (on molecules) separates
    its first layer's leaves from its last's."""
    jc, tc = pair(arch, node_level)
    if layers is not None:
        jc = dataclasses.replace(jc, n_layers=layers)
        tc = dataclasses.replace(tc, n_layers=layers)
    batch, n_graphs = (node_batch(arch, jc.d_in) if node_level
                       else molecule_batch(arch, jc.d_in))
    _, jg, _ = j_reference(jc, arch, n_graphs, node_level)(
        j_params(arch, jc), on_jax(batch))
    zero = sorted(k for k, g in flatten_with_paths(jax.device_get(jg))
                  if not np.any(np.asarray(g)))
    assert zero == _chip_smoke().gnn_unreached(arch, tc)


# ---------------------------------------------------------------------------
# the port's own property tests
# ---------------------------------------------------------------------------

def _rotation(seed):
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q @ np.diag(np.sign(np.diag(r)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return torch.tensor(q, dtype=torch.float32)


def _mol(arch, seed):
    cfg = get_arch(arch).make_smoke_config()
    m = synthetic_molecules(4, 8, 16, cfg.d_in, seed=seed, triplet_cap=8)
    params = S._GNN[arch].init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")

    def batch(pos):
        return make_batch_from_arrays(
            m["nodes"], m["edge_src"], m["edge_dst"], pos=pos,
            graph_id=m["graph_id"], n_graphs=m["n_graphs"],
            triplets=m["triplets"], device="cpu")
    return cfg, params, t(m["pos"]), batch


@pytest.mark.parametrize("seed", [0, 1])
def test_egnn_is_e_n_equivariant(seed):
    """Rotated and shifted positions: invariant outputs, coordinates
    rotated and shifted alike."""
    cfg, params, pos, batch = _mol("egnn", seed)
    R, shift = _rotation(seed), torch.tensor([1.5, -2.0, 0.5])
    out1, x1 = egnn.forward(params, batch(pos), cfg)
    out2, x2 = egnn.forward(params, batch(pos @ R.T + shift), cfg)
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(x2.numpy(), (x1 @ R.T + shift).numpy(),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_mace_is_e3_equivariant(seed):
    """Invariant energy; vector features rotate (v R^T) and rank-2 ones
    conjugate (R t R^T)."""
    cfg, params, pos, batch = _mol("mace", seed)
    R, shift = _rotation(seed + 10), torch.tensor([0.3, 0.1, -0.7])
    e1, f1 = mace.forward(params, batch(pos), cfg)
    e2, f2 = mace.forward(params, batch(pos @ R.T + shift), cfg)
    assert float(f1["t"].abs().max()) > 0
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(f2["v"].numpy(), (f1["v"] @ R.T).numpy(),
                               atol=2e-3, rtol=2e-3)
    want_t = torch.einsum("ab,ncbd,ed->ncae", R, f1["t"], R)
    np.testing.assert_allclose(f2["t"].numpy(), want_t.numpy(), atol=2e-3,
                               rtol=2e-3)


def test_dimenet_is_rototranslation_invariant():
    cfg, params, pos, batch = _mol("dimenet", 0)
    R = _rotation(20)
    e1 = dimenet.forward(params, batch(pos), cfg)
    e2 = dimenet.forward(params, batch(pos @ R.T + 3.0), cfg)
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), atol=1e-3, rtol=1e-3)


def test_gin_is_permutation_invariant():
    rng = np.random.default_rng(0)
    N, E, F = 10, 30, 8
    nodes = rng.standard_normal((N, F)).astype(np.float32)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    cfg = gin.GINConfig(d_in=F, n_layers=2, d_hidden=16, n_classes=3)
    params = gin.init_params(cfg, device="cpu")
    out1 = gin.forward(params, make_batch_from_arrays(nodes, src, dst,
                                                      device="cpu"), cfg)
    perm = rng.permutation(N)
    inv = np.argsort(perm)
    out2 = gin.forward(params, make_batch_from_arrays(
        nodes[perm], inv[src], inv[dst], device="cpu"), cfg)
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_bilinear_equals_the_einsum():
    """The explicit bilinear contraction equals the three-operand einsum
    the reference writes."""
    g = torch.Generator().manual_seed(0)
    sbf = torch.randn(50, 3, generator=g)
    w = torch.randn(3, 8, 8, generator=g)
    m = torch.randn(50, 8, generator=g)
    np.testing.assert_allclose(
        dimenet.bilinear(sbf, w, m).numpy(),
        torch.einsum("tb,bde,te->td", sbf, w, m).numpy(), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_init_params_names_shapes_dtypes(arch):
    """``init_params`` of the full config: the reference's tree of names,
    shapes and dtypes, from an explicit generator, on the CPU."""
    spec = get_arch(arch)
    cfg = cfg_for_cell(spec, GNN_SHAPES[0])
    jc = jdryrun._gnn_cfg_for_cell(j_get_arch(arch), j_get_arch(
        arch).shapes[0])
    want = jax.eval_shape(functools.partial(JS._GNN[arch].init_params,
                                            cfg=jc), jax.random.PRNGKey(0))
    got = S._GNN[arch].init_params(
        cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    w = {k: (tuple(v.shape), str(v.dtype))
         for k, v in flatten_with_paths(want)}
    g = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in flatten_with_paths(got)}
    assert g == w
