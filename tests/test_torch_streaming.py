"""repro_torch's incremental ``Decomposition.update(delta)`` against the
reference's and against a fresh ``decompose``.

* PARITY: after every delta of a randomized insert/delete sequence at
  (1,2) and (2,3), the port's artifact equals the reference's ``update``
  on the same incidence arrays (the edited problem's five tables, core,
  peel values, forest and ``UpdateStats``) and a fresh ``decompose`` of the
  edited graph (core, peel values, forest, tree, cuts).
* DELTA: ``GraphDelta`` canonicalizes, rejects self-loops, and updates are
  strict about insert-present / delete-absent / out-of-range edges.
* ERRORS: approx artifacts, unsupported (r, s), replay/two_phase/basic
  hierarchies and problem-less artifacts raise the reference's errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.incidence import NucleusProblem as JProblem
from repro.graph.container import Graph as JGraph

from repro_torch import Decomposition, GraphDelta, NucleusConfig, decompose
from repro_torch.core.incidence import build_problem
from repro_torch.core.streaming import SUPPORTED_RS
from repro_torch.graph.container import make_graph
from repro_torch.graph.generators import golden_suite

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

GRAPHS = golden_suite()
FIELDS = ("r_cliques", "inc_rid", "mem_offsets", "mem_sids", "deg0")


def jproblem(p):
    return JProblem(g=JGraph(n=p.g.n, edges=jnp.asarray(p.g.edges.numpy())),
                    r=p.r, s=p.s,
                    **{f: jnp.asarray(getattr(p, f).numpy()) for f in FIELDS},
                    orientation=p.orientation)


def edge_set(g):
    return {tuple(r) for r in g.edges.numpy().tolist()}


def absent_pairs(g, rng, k):
    present = edge_set(g)
    out = [(u, v) for u in range(g.n) for v in range(u + 1, g.n)
           if (u, v) not in present]
    rng.shuffle(out)
    return out[:k]


def pair(dec, cfg):
    """The port's artifact and the reference's, decomposed from the same
    incidence arrays."""
    jcfg = jcore.NucleusConfig(r=cfg.r, s=cfg.s, method=cfg.method,
                               hierarchy=cfg.hierarchy)
    return jcore.decompose(jproblem(dec.problem), jcfg)


def assert_matches_reference(dec, jdec, label):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(dec.problem, f).numpy(),
                                      np.asarray(getattr(jdec.problem, f)),
                                      err_msg=f"{label}: problem {f}")
    np.testing.assert_array_equal(dec.problem.g.edges.numpy(),
                                  np.asarray(jdec.problem.g.edges))
    for f in ("core", "peel_value", "uf_parent", "uf_L"):
        want = getattr(jdec, f)
        if want is None:
            assert getattr(dec, f) is None, f"{label}: {f}"
            continue
        np.testing.assert_array_equal(getattr(dec, f), np.asarray(want),
                                      err_msg=f"{label}: {f}")
    assert vars(dec.update_stats) == vars(jdec.update_stats), label
    assert (dec.rounds, dec.version) == (jdec.rounds, jdec.version)


def assert_matches_fresh(dec, cfg, label):
    fresh = decompose(dec.problem.g, cfg, device="cpu")
    for f in ("core", "peel_value"):
        np.testing.assert_array_equal(getattr(dec, f), getattr(fresh, f),
                                      err_msg=f"{label}: {f}")
    if cfg.hierarchy == "fused":
        for f in ("uf_parent", "uf_L"):
            np.testing.assert_array_equal(getattr(dec, f),
                                          getattr(fresh, f),
                                          err_msg=f"{label}: {f}")
        np.testing.assert_array_equal(dec.tree.parent, fresh.tree.parent)
        np.testing.assert_array_equal(dec.tree.level, fresh.tree.level)
        kmax = int(fresh.core.max(initial=0))
        for c in {1, max(kmax, 1)}:
            np.testing.assert_array_equal(dec.cut(c), fresh.cut(c),
                                          err_msg=f"{label}: cut({c})")


# ---------------------------------------------------------------------------
# GraphDelta
# ---------------------------------------------------------------------------

def test_graphdelta_canonicalizes_and_orders_ops():
    d = GraphDelta(insert=np.array([[5, 2]]), delete=np.array([[1, 0]]))
    np.testing.assert_array_equal(d.insert, [[2, 5]])
    np.testing.assert_array_equal(d.delete, [[0, 1]])
    assert d.n_ops == 2
    assert [op for op, _, _ in d.ops()] == ["delete", "insert"]
    jd = jcore.GraphDelta(insert=np.array([[5, 2]]),
                          delete=np.array([[1, 0]]))
    assert list(d.ops()) == list(jd.ops())


@pytest.mark.parametrize("field", ["insert", "delete"])
def test_graphdelta_rejects_self_loops(field):
    with pytest.raises(ValueError, match="self-loop"):
        GraphDelta(**{field: np.array([[3, 3]])})


def test_update_rejects_drifted_view():
    g = GRAPHS["two_triangles"](device="cpu")
    dec = decompose(g, NucleusConfig(r=1, s=2), device="cpu")
    present = next(iter(edge_set(g)))
    with pytest.raises(ValueError, match="insert of present edge"):
        dec.update(GraphDelta(insert=np.array([present])))
    absent = absent_pairs(g, np.random.default_rng(0), 1)[0]
    with pytest.raises(ValueError, match="delete of absent edge"):
        dec.update(GraphDelta(delete=np.array([absent])))
    with pytest.raises(ValueError, match="out of range"):
        dec.update(GraphDelta(insert=np.array([[0, g.n]])))


# ---------------------------------------------------------------------------
# Parity: the reference's update and a fresh decompose, after every delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,s", sorted(SUPPORTED_RS))
@pytest.mark.parametrize("name", ["bowtie_plus", "er20", "planted40"])
def test_update_parity_randomized(name, r, s):
    rng = np.random.default_rng(7)
    cfg = NucleusConfig(r=r, s=s)
    dec = decompose(GRAPHS[name](device="cpu"), cfg, device="cpu")
    jdec = pair(dec, cfg)
    for step in range(6):
        g = dec.problem.g
        present = sorted(edge_set(g))
        absent = absent_pairs(g, rng, 1)
        if absent and (rng.random() < 0.5 or len(present) <= 2):
            kw = dict(insert=np.array([absent[0]]))
        else:
            kw = dict(delete=np.array([present[rng.integers(len(present))]]))
        dec = dec.update(GraphDelta(**kw))
        jdec = jdec.update(jcore.GraphDelta(**kw))
        label = f"{name} r{r}s{s} step{step}"
        assert dec.rounds == -1 and dec.order_round is None
        assert dec.version == step + 1
        assert_matches_reference(dec, jdec, label)
        assert_matches_fresh(dec, cfg, label)


@pytest.mark.parametrize("r,s", sorted(SUPPORTED_RS))
def test_update_batched_delta_mixed_ops(r, s):
    rng = np.random.default_rng(3)
    cfg = NucleusConfig(r=r, s=s)
    g = GRAPHS["fig1"](device="cpu")
    dec = decompose(g, cfg, device="cpu")
    jdec = pair(dec, cfg)
    kw = dict(insert=np.array(absent_pairs(g, rng, 2)),
              delete=np.array(sorted(edge_set(g))[:2]))
    dec = dec.update(GraphDelta(**kw))
    assert dec.update_stats.ops == 4
    assert_matches_reference(dec, jdec.update(jcore.GraphDelta(**kw)),
                             f"batched r{r}s{s}")
    assert_matches_fresh(dec, cfg, f"batched r{r}s{s}")


def test_update_without_hierarchy():
    cfg = NucleusConfig(hierarchy="none")
    g = GRAPHS["two_triangles"](device="cpu")
    dec = decompose(g, cfg, device="cpu")
    pair_ = absent_pairs(g, np.random.default_rng(1), 1)[0]
    dec = dec.update(GraphDelta(insert=np.array([pair_])))
    assert dec.uf_parent is None and dec.uf_L is None
    assert_matches_fresh(dec, cfg, "no-hierarchy")


def test_update_insert_delete_roundtrip_restores_core():
    cfg = NucleusConfig(r=1, s=2)
    g = GRAPHS["er20"](device="cpu")
    dec0 = decompose(g, cfg, device="cpu")
    pair_ = absent_pairs(g, np.random.default_rng(2), 1)[0]
    dec1 = dec0.update(GraphDelta(insert=np.array([pair_])))
    dec2 = dec1.update(GraphDelta(delete=np.array([pair_])))
    for f in ("core", "uf_parent", "uf_L"):
        np.testing.assert_array_equal(getattr(dec2, f), getattr(dec0, f))
    # the old artifact stays valid for the old graph
    np.testing.assert_array_equal(dec0.problem.g.edges.numpy(),
                                  g.edges.numpy())


def test_update_localizes_small_edits():
    """An edit in a low-core region never floods across a higher-core
    bottleneck: the K8's vertices are not candidates."""
    cfg = NucleusConfig(r=1, s=2, hierarchy="none")
    k8 = [[i, j] for i in range(8) for j in range(i + 1, 8)]
    g = make_graph(11, np.array(k8 + [[8, 9], [9, 10]]), device="cpu")
    dec = decompose(g, cfg, device="cpu").update(
        GraphDelta(insert=np.array([[8, 10]])))
    assert dec.update_stats.candidates <= 3, dec.update_stats
    assert_matches_fresh(dec, cfg, "pendant-insert")


def test_update_keeps_the_problem_on_its_device():
    dec = decompose(GRAPHS["er20"](device="cpu"), NucleusConfig(),
                    device="cpu")
    new = dec.update(GraphDelta(delete=np.array([sorted(edge_set(
        dec.problem.g))[0]])))
    assert new.problem.device.type == "cpu"
    assert new.problem.build_stats == {"build": "streaming"}
    np.testing.assert_array_equal(
        new.problem.r_cliques.numpy(), new.problem.g.edges.numpy())
    # at (2,3) the r-clique table is the lexsorted edge list, so the
    # edited r-clique side equals a fresh build's (the s-rows may differ
    # in order)
    want = build_problem(new.problem.g, 2, 3, device="cpu")
    for f in ("r_cliques", "deg0", "mem_offsets"):
        np.testing.assert_array_equal(getattr(new.problem, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    assert new.problem.n_s == want.n_s


# ---------------------------------------------------------------------------
# Error paths (the reference's messages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,word", [
    ("approx", "exact"), ("r3s4", r"\(r, s\)"), ("replay", "fused"),
    ("two_phase", "fused"), ("basic", "fused"), ("loaded", "re-decompose")])
def test_update_refusals(case, word):
    cfgs = {"approx": NucleusConfig(method="approx", delta=0.25,
                                    hierarchy="none"),
            "r3s4": NucleusConfig(r=3, s=4, hierarchy="none"),
            "replay": NucleusConfig(hierarchy="replay"),
            "two_phase": NucleusConfig(hierarchy="two_phase"),
            "basic": NucleusConfig(hierarchy="basic"),
            "loaded": NucleusConfig()}
    name = "planted40" if case == "r3s4" else "two_triangles"
    dec = decompose(GRAPHS[name](device="cpu"), cfgs[case], device="cpu")
    if case == "loaded":
        dec = Decomposition.from_json(dec.to_json())
    with pytest.raises(ValueError, match=word):
        dec.update(GraphDelta(insert=np.array([[0, 1]])))


def test_chain_forest_breaks_L_ties_apart_from_the_fused_peel():
    """The reference's own limit, pinned: ``update`` re-resolves the
    canonical chain multiset, whose forest has the fused peel's parent and
    tree but can break an L tie differently (one entry on this 4,136
    r-clique graph).  The port reproduces the reference's chain forest
    bit for bit; core, parent, tree and cuts stay exact."""
    import torch

    from repro.core.streaming import _chains as jchains
    from repro.core.streaming import _run_fixpoint as jrun_fixpoint
    from repro_torch.core.interleaved import (construct_tree_efficient,
                                              link_state_from_forest)
    from repro_torch.core.streaming import _chain_forest
    from repro_torch.graph.generators import community_power_law

    dec = decompose(community_power_law(500, seed=0, device="cpu"),
                    NucleusConfig(), device="cpu")
    p, n = dec.problem, dec.n_r
    parent, L = _chain_forest(p.inc_rid, torch.as_tensor(dec.core), None)
    inc, core64 = p.inc_rid.numpy().astype(np.int64), dec.core.astype(
        np.int64)
    jparent, jL = jrun_fixpoint(np.arange(n), np.full(n, -1), core64,
                                *jchains(inc, core64), None)
    np.testing.assert_array_equal(parent, jparent)
    np.testing.assert_array_equal(L, jL)
    np.testing.assert_array_equal(parent, dec.uf_parent)
    assert int((L != dec.uf_L).sum()) == 1
    tree = construct_tree_efficient(p, link_state_from_forest(
        dec.core, parent, L))
    np.testing.assert_array_equal(tree.parent, dec.tree.parent)
    np.testing.assert_array_equal(tree.level, dec.tree.level)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_local_converge_matches_the_reference(seed):
    """h_index_rows, local_converge and kcore_local_converge against the
    reference's on random subproblems: the reference's padded (m, d)
    lists become the port's (owner, value) pairs."""
    import torch

    from repro.core.engine import h_index_rows as jh_index_rows
    from repro.core.engine import local_converge as jlocal_converge
    from repro.core.kcore import kcore_local_converge as jkcore_converge
    from repro_torch.core.engine import h_index_rows, local_converge
    from repro_torch.core.kcore import kcore_local_converge

    rng = np.random.default_rng(seed)
    vals = rng.integers(-1, 9, (40, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        h_index_rows(torch.from_numpy(vals)).numpy(),
        np.asarray(jh_index_rows(jnp.asarray(vals))))

    def pairs(padded, sentinel):
        own, col = np.nonzero(padded != sentinel)
        return torch.from_numpy(own), torch.from_numpy(padded[own, col])

    m, rows, C = 30, 50, 3
    inc = rng.integers(0, m, (rows, C)).astype(np.int32)
    inc[rows - 5:] = -1                                  # padding rows
    flat = inc.reshape(-1)
    keep = np.flatnonzero(flat >= 0)
    deg = np.bincount(flat[keep], minlength=m)
    gather = np.full((m, max(int(deg.max()), 1)), rows * C, np.int32)
    fill = np.zeros(m, np.int64)
    for k in keep:
        gather[flat[k], fill[flat[k]]] = k
        fill[flat[k]] += 1
    vals0 = rng.integers(0, 12, m).astype(np.int32)
    frozen = rng.random(m) < 0.3
    cap = int(vals0[~frozen].sum()) + 2
    want, wsweeps = jlocal_converge(jnp.asarray(inc), jnp.asarray(gather),
                                    jnp.asarray(vals0), jnp.asarray(frozen),
                                    jnp.asarray(cap))
    got, sweeps = local_converge(torch.from_numpy(inc),
                                 *pairs(gather, rows * C),
                                 torch.from_numpy(vals0),
                                 torch.from_numpy(frozen), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sweeps == int(wsweeps)

    nbr = np.full((m, 6), m, np.int32)
    for i in range(m):
        k = rng.integers(0, 7)
        nbr[i, :k] = rng.integers(0, m, k)
    want, wsweeps = jkcore_converge(jnp.asarray(nbr), jnp.asarray(vals0),
                                    jnp.asarray(frozen), jnp.asarray(cap))
    got, sweeps = kcore_local_converge(*pairs(nbr, m),
                                       torch.from_numpy(vals0),
                                       torch.from_numpy(frozen), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sweeps == int(wsweeps)
