"""Seeded graph generators (numpy), counterpart of ``repro.graph.generators``.

The golden-fixture suite and ``barabasi_albert`` are copies of the
reference's, so the port's tests re-derive the same graphs from the same
seeds.  ``community_power_law`` is the port's own: a vectorized generator
of ~10^6-vertex graphs with many triangles, used by ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np

from ..device import DeviceLike
from .container import Graph, make_graph


def erdos_renyi(n: int, p: float, seed: int = 0,
                device: DeviceLike = None) -> Graph:
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    mask = rng.random(iu[0].shape[0]) < p
    edges = np.stack([iu[0][mask], iu[1][mask]], axis=1)
    return make_graph(n, edges, device)


def barabasi_albert(n: int, k: int, seed: int = 0,
                    device: DeviceLike = None) -> Graph:
    """Preferential attachment: power-law degrees (high clique counts).

    The reference's generator, draw for draw: ``rng.choice`` over the
    endpoint list makes the same draws whether the list is a Python list
    or a numpy prefix, so the list lives in a preallocated array and is
    not converted anew for every vertex (ba4k in ~0.1 s instead of ~9 s).
    """
    rng = np.random.default_rng(seed)
    repeated = np.empty(k + 2 * k * max(n - k, 0), dtype=np.int64)
    repeated[:k] = np.arange(k)
    size = k
    edges = []
    for v in range(k, n):
        chosen = rng.choice(repeated[:size], size=min(k, size),
                            replace=False)
        for t in set(int(c) for c in chosen):
            edges.append((v, t))
            repeated[size:size + 2] = (t, v)
            size += 2
    return make_graph(n, np.asarray(edges, dtype=np.int64).reshape(-1, 2),
                      device)


def planted_cliques(n: int, clique_sizes, p_background: float = 0.01,
                    seed: int = 0, device: DeviceLike = None) -> Graph:
    """Background ER graph + planted cliques: a known nested density."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    mask = rng.random(iu[0].shape[0]) < p_background
    edges = [np.stack([iu[0][mask], iu[1][mask]], axis=1)]
    start = 0
    for size in clique_sizes:
        members = np.arange(start, min(start + size, n))
        ij = np.triu_indices(len(members), k=1)
        edges.append(np.stack([members[ij[0]], members[ij[1]]], axis=1))
        start += max(1, size // 2)  # overlap consecutive cliques
    return make_graph(n, np.concatenate(edges, axis=0), device)


def paper_figure1_like(device: DeviceLike = None) -> Graph:
    """A small graph with the nested (1,3)-nucleus structure of Fig. 1."""
    edges = [
        # dense core: K5 on 0..4
        (0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4), (2, 3),
        (2, 4), (3, 4),
        # middle shell: triangles sharing edges with the core boundary
        (3, 5), (4, 5), (5, 6), (3, 6), (5, 7), (6, 7),
        # outer: one triangle
        (7, 8), (6, 8),
    ]
    return make_graph(9, np.asarray(edges, dtype=np.int64), device)


def golden_suite():
    """The golden-fixture graph suite: name -> Graph factory(device=None).

    The same graphs, seeds and parameters as the reference's
    ``golden_suite`` (tests/golden/*.json were generated from it).
    """
    return {
        "triangle": lambda device=None: tiny_named("triangle", device),
        "k4": lambda device=None: tiny_named("k4", device),
        "path4": lambda device=None: tiny_named("path4", device),
        "two_triangles": lambda device=None: tiny_named("two_triangles",
                                                        device),
        "bowtie_plus": lambda device=None: tiny_named("bowtie_plus", device),
        "fig1": paper_figure1_like,
        "er20": lambda device=None: erdos_renyi(20, 0.35, seed=1,
                                                device=device),
        "planted40": lambda device=None: planted_cliques(
            40, [8, 6, 5], 0.05, seed=3, device=device),
    }


GOLDEN_RS = [(1, 2), (2, 3), (3, 4)]


def tiny_named(name: str, device: DeviceLike = None) -> Graph:
    if name == "triangle":
        return make_graph(3, [(0, 1), (1, 2), (0, 2)], device)
    if name == "k4":
        return make_graph(4, [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
                          device)
    if name == "path4":
        return make_graph(4, [(0, 1), (1, 2), (2, 3)], device)
    if name == "two_triangles":
        # two triangles sharing one vertex
        return make_graph(5, [(0, 1), (1, 2), (0, 2), (2, 3), (3, 4), (2, 4)],
                          device)
    if name == "bowtie_plus":
        # two K4s joined by an edge
        e = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3),
             (4, 5), (4, 6), (4, 7), (5, 6), (5, 7), (6, 7), (3, 4)]
        return make_graph(8, e, device)
    raise ValueError(name)


# community_power_law: background and community shape (see its docstring)
BG_MEAN_DEGREE = 13.0
BG_EXPONENT = 2.5
BG_MAX_WEIGHT = 600.0
COMMUNITY_SIZES = (24, 32, 40, 48, 56)
COMMUNITY_P = (0.2, 0.6)
VERTICES_PER_COMMUNITY = 100


def community_power_law_edges(n: int, seed: int = 0) -> np.ndarray:
    """Edge list (E, 2) int64 of a power-law graph with planted communities.

    * Background: a Chung-Lu graph whose expected degrees follow a power
      law (exponent 2.5, mean 13), capped at 600 so the oriented adjacency
      (n x max out-degree) stays small.  It carries few triangles.
    * Communities: n/100 groups whose sizes cycle through 24..56; members
      are drawn uniformly, so groups overlap and a vertex can sit in
      several.  Each group is an Erdos-Renyi graph with its own edge
      probability drawn from U(0.2, 0.6).  They carry nearly all triangles
      and the nested dense regions the hierarchy is about.

    At n = 10^6 that is ~10^7 edges and ~10^7 triangles, the scale of the
    paper's com-youtube / as-skitter inputs.  Everything is vectorized
    numpy; the same (n, seed) gives the same list.  Duplicates and
    self-loops are left to ``make_graph``.
    """
    rng = np.random.default_rng(seed)
    # -- power-law background (Chung-Lu, endpoints drawn by weight)
    w = (np.arange(n, dtype=np.float64) + 1.0) ** (-1.0 / (BG_EXPONENT - 1.0))
    w *= BG_MEAN_DEGREE * n / w.sum()
    w = np.minimum(w, BG_MAX_WEIGHT)
    perm = rng.permutation(n)  # hubs get random ids
    p = w / w.sum()
    m_bg = int(BG_MEAN_DEGREE * n / 2)
    u = perm[rng.choice(n, size=m_bg, p=p)]
    v = perm[rng.choice(n, size=m_bg, p=p)]
    parts = [np.stack([u, v], axis=1)]
    # -- overlapping planted communities
    n_comm = max(1, n // VERTICES_PER_COMMUNITY)
    for i, k in enumerate(COMMUNITY_SIZES):
        count = n_comm // len(COMMUNITY_SIZES) + \
            (1 if i < n_comm % len(COMMUNITY_SIZES) else 0)
        if count == 0 or k > n:
            continue
        members = rng.integers(0, n, size=(count, k))
        iu = np.triu_indices(k, k=1)
        prob = rng.uniform(COMMUNITY_P[0], COMMUNITY_P[1], size=(count, 1))
        keep = rng.random((count, iu[0].shape[0])) < prob
        parts.append(np.stack([members[:, iu[0]][keep],
                               members[:, iu[1]][keep]], axis=1))
    return np.concatenate(parts, axis=0).astype(np.int64)


def community_power_law(n: int, seed: int = 0,
                        device: DeviceLike = None) -> Graph:
    """``make_graph`` over ``community_power_law_edges(n, seed)``."""
    return make_graph(n, community_power_law_edges(n, seed), device)
