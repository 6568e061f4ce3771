"""Serving driver: LM decode and nucleus queries (counterpart of
``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch minicpm-2b`` prefills waves of
prompts and decodes tokens with the KV cache, on the card by default
(``--device cpu`` runs the plain path).  Requests are served in waves of
``batch_slots``: the slots of a wave share one cache length, each wave
prefills by one-token decode steps over its prompts and then decodes
``gen_len - 1`` more tokens, exactly as the reference's loop does.

``--arch nucleus`` is the build-once/query-many lane: it loads a
serialized ``Decomposition`` (``--decomposition path.json``; without one a
small graph is decomposed, serialized and reloaded) and answers batched
``cut``/``nuclei`` queries with latency stats.  ``--warm-pool`` drives a
stream of graphs through the plan-aware ``repro_torch.serve.Router``
(``--r/--s/--method`` take comma lists for mixed tenant configs).
``--server`` starts the multi-tenant front end (the bounded-queue
``Frontend`` and the stdlib HTTP surface), with ``--cache-dir`` holding the
kernel build cache and the session manifest so a restarted server
pre-warms its pools; ``--selftest`` drives a short mixed workload over
HTTP (decompose, query, update, status) and exits.  Every lane runs on the
card unless ``--device cpu`` is given.  The DIN lane (``--arch din``) is
not yet ported and raises.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..device import DeviceLike, resolve_device
from ..models import transformer as T
from . import steps as S

NOT_PORTED = ("din",)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch_id: str, n_requests: int = 16, batch_slots: int = 4,
             prompt_len: int = 16, gen_len: int = 24, smoke: bool = True,
             quiet: bool = False, params: Optional[Dict[str, Any]] = None,
             device: DeviceLike = None) -> Dict[int, np.ndarray]:
    """Serve ``n_requests`` seeded prompts; returns {request: tokens}.

    ``params=None`` draws the port's own seeded parameters
    (``transformer.init_params``); pass converted reference parameters to
    compare with the reference token for token.  The prompts come from
    ``np.random.default_rng(0)`` as in the reference.
    """
    if arch_id in NOT_PORTED:
        raise NotImplementedError(f"--arch {arch_id} is not yet ported to "
                                  f"repro_torch; it serves the dense LM "
                                  f"archs and --arch nucleus")
    if arch_id == "nucleus":
        raise ValueError("--arch nucleus is no LM: serve it with "
                         "serve_nucleus, serve_nucleus_warm_pool or "
                         "serve_nucleus_server")
    dev = resolve_device(device)
    spec = get_arch(arch_id)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    if params is None:
        params = T.init_params(cfg, device=dev)
    max_len = prompt_len + gen_len
    rng = np.random.default_rng(0)
    queue: List[np.ndarray] = [
        rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
        for _ in range(n_requests)]
    produced: Dict[int, np.ndarray] = {}
    done = 0
    _sync(dev)
    t0 = time.perf_counter()
    wave = 0
    while done < n_requests:
        take = queue[wave * batch_slots:(wave + 1) * batch_slots]
        if not take:
            break
        bs = len(take)
        toks = torch.from_numpy(np.stack(
            [np.pad(t, (0, prompt_len - len(t))) for t in take])).to(dev)
        cache = T.init_cache(cfg, bs, max_len, device=dev)
        # prefill via decode steps over the prompt (simple + exact)
        cache_len = 0
        last = None
        for i in range(prompt_len):
            last, cache, cache_len = S.lm_decode_step(
                params, toks[:, i:i + 1], cache, cache_len, cfg)
        outs = [last]
        for _ in range(gen_len - 1):
            nxt, cache, cache_len = S.lm_decode_step(
                params, outs[-1][:, None], cache, cache_len, cfg)
            outs.append(nxt)
        gen = torch.stack(outs, dim=1).cpu().numpy()  # (bs, gen_len)
        for bi in range(bs):
            produced[wave * batch_slots + bi] = gen[bi]
        done += bs
        wave += 1
    _sync(dev)
    dt = time.perf_counter() - t0
    if not quiet:
        tput = done * gen_len / dt
        print(f"served {done} requests, {gen_len} tokens each, "
              f"{tput:.1f} tok/s ({dev.type})")
    return produced


def _parse_pool_configs(r: str, s: str, method: str
                        ) -> List[Tuple[int, int, str]]:
    """Comma-list flag values -> positional (r, s, method) tuples (length-1
    lists broadcast), validated so a bad pair fails at the CLI."""
    rs = [int(x) for x in str(r).split(",")]
    ss = [int(x) for x in str(s).split(",")]
    ms = [m.strip() for m in str(method).split(",")]
    width = max(len(rs), len(ss), len(ms))

    def bcast(xs):
        return xs * width if len(xs) == 1 else xs
    rs, ss, ms = bcast(rs), bcast(ss), bcast(ms)
    if not len(rs) == len(ss) == len(ms):
        raise SystemExit(
            f"--r/--s/--method comma lists must broadcast to one length; "
            f"got {len(rs)}/{len(ss)}/{len(ms)}")
    for rr, sv in zip(rs, ss):
        if not 1 <= rr < sv:
            raise SystemExit(f"need 1 <= r < s, got ({rr}, {sv})")
    return list(zip(rs, ss, ms))


def serve_nucleus_warm_pool(n_graphs: int = 5, n_queries: int = 32,
                            seed: int = 0, bucket_cap: int = 0,
                            r: str = "2", s: str = "3",
                            method: str = "exact", quiet: bool = False,
                            device: DeviceLike = None):
    """Warm-pool serving through the plan-aware router.

    Tenants submit similar-sized graphs under (possibly mixed) configs; the
    ``Router`` keys a ``Session`` pool per canonical config, so same-config
    same-bucket graphs are warm hits, and each artifact then answers
    cut/nuclei queries.  Graphs round-robin over the ``--r/--s/--method``
    tuples.  Prints the decompose latency (cold vs warm), the pools' hit
    rates and the query latency; returns a stats dict (query percentiles
    are None when ``n_queries == 0``).
    """
    from ..core.incidence import build_problem
    from ..graph import generators
    from ..serve import Request, Router

    dev = resolve_device(device)
    if n_graphs < 1:
        raise SystemExit("--pool-graphs must be >= 1")
    configs = _parse_pool_configs(r, s, method)
    router = Router(device=dev,
                    **({"bucket_cap": bucket_cap} if bucket_cap else {}))
    rng = np.random.default_rng(seed)
    dec_s: List[float] = []
    lat_us: List[float] = []
    queries = 0
    # the incidence structures are built up front; the timer below
    # isolates the peel and hierarchy the Sessions run
    requests = []
    for gi in range(n_graphs):
        # sizes drift but stay inside one power-of-two shape class
        g = generators.planted_cliques(118 + 2 * gi, [10, 8, 6], 0.03,
                                       seed=seed + gi, device=dev)
        rr, sv, mm = configs[gi % len(configs)]
        requests.append(Request(graph=build_problem(g, rr, sv, device=dev),
                                r=rr, s=sv, method=mm))
    for req in requests:
        _sync(dev)
        t0 = time.perf_counter()
        dec = router.route(req)
        _sync(dev)
        dec_s.append(time.perf_counter() - t0)
        kmax = int(dec.core.max()) if dec.n_r else 0
        for c in rng.integers(1, max(kmax, 1) + 1, size=n_queries):
            t0 = time.perf_counter()
            dec.nuclei(int(c)) if queries % 2 else dec.cut(int(c))
            lat_us.append((time.perf_counter() - t0) * 1e6)
            queries += 1
    report = router.report()
    pools = report["pools"]
    warm_hits = sum(p["stats"]["warm"] for p in pools)
    n_buckets = sum(len(p["buckets"]) for p in pools)
    lat = np.asarray(lat_us)
    warm = float(np.median(dec_s[1:])) if dec_s[1:] else None
    stats = {"graphs": n_graphs, "queries": queries,
             "configs": [f"{m}-r{rr}s{sv}" for rr, sv, m in configs],
             "decompose_cold_s": dec_s[0],
             "decompose_warm_s": warm,
             "p50_us": float(np.percentile(lat, 50)) if queries else None,
             "p95_us": float(np.percentile(lat, 95)) if queries else None,
             "pools": [{"config": p["config"], "stats": p["stats"],
                        "hit_rate": p["hit_rate"]} for p in pools],
             "warm_hits": warm_hits,
             "n_buckets": n_buckets}
    if not quiet:
        warm_txt = "no warm calls (pool of 1)" if warm is None else (
            f"warm median {warm * 1e3:.0f}ms "
            f"({dec_s[0] / max(warm, 1e-9):.1f}x)")
        q_txt = "0 queries" if not queries else (
            f"{queries} queries p50={stats['p50_us']:.0f}us "
            f"p95={stats['p95_us']:.0f}us")
        print(f"warm pool ({dev.type}): {n_graphs} graphs through "
              f"{len(pools)} router pool(s) ({n_buckets} shape bucket(s), "
              f"{warm_hits} warm hits): cold {dec_s[0] * 1e3:.0f}ms, "
              f"{warm_txt}; {q_txt}")
    return stats


def serve_nucleus(path: str = "", n_queries: int = 64, batch: int = 8,
                  seed: int = 0, quiet: bool = False,
                  device: DeviceLike = None):
    """Nucleus-query serving: decompose once (offline), query many (here).

    Loads a serialized ``Decomposition`` and answers ``n_queries`` queries
    in fixed-size batches, alternating ``cut(c)`` and ``nuclei(c)`` over
    random levels c; the first query per level pays the lazy tree/cut
    build, repeats hit the cache.  Without ``path`` a small planted graph
    is decomposed on ``device``, serialized and reloaded.  Returns a stats
    dict (also printed unless quiet).
    """
    from ..core.api import Decomposition, NucleusConfig, decompose

    dev = resolve_device(device)
    if path:
        dec = Decomposition.load(path)
    else:
        from ..graph import generators
        g = generators.planted_cliques(120, [10, 8, 6], 0.03, seed=3,
                                       device=dev)
        offline = decompose(g, NucleusConfig(r=2, s=3, backend="dense",
                                             hierarchy="fused"), device=dev)
        dec = Decomposition.from_json(offline.to_json())
    kmax = int(dec.core.max()) if dec.n_r else 0
    rng = np.random.default_rng(seed)
    lat_us: List[float] = []
    n_cut = n_nuc = 0
    t_all = time.perf_counter()
    for start in range(0, n_queries, batch):
        cs = rng.integers(1, max(kmax, 1) + 1, size=min(batch,
                                                        n_queries - start))
        for qi, c in enumerate(cs):
            t0 = time.perf_counter()
            if (start + qi) % 2 == 0:
                dec.cut(int(c))
                n_cut += 1
            else:
                dec.nuclei(int(c))
                n_nuc += 1
            lat_us.append((time.perf_counter() - t0) * 1e6)
    dt = time.perf_counter() - t_all
    lat = np.asarray(lat_us)
    served = len(lat_us)
    stats = {"queries": served, "cut": n_cut, "nuclei": n_nuc,
             "qps": served / max(dt, 1e-9),
             "p50_us": float(np.percentile(lat, 50)) if served else None,
             "p95_us": float(np.percentile(lat, 95)) if served else None,
             "max_us": float(lat.max()) if served else None,
             "n_r": dec.n_r, "kmax": kmax}
    if not quiet:
        q_txt = "0 queries" if not served else (
            f"{stats['qps']:.0f} q/s, p50={stats['p50_us']:.0f}us "
            f"p95={stats['p95_us']:.0f}us max={stats['max_us']:.0f}us")
        print(f"served {served} nucleus queries "
              f"({n_cut} cut, {n_nuc} nuclei) from a serialized "
              f"decomposition (n_r={dec.n_r}, kmax={kmax}): {q_txt}")
    return stats


def _selftest_workload(host: str, port: int,
                       quiet: bool = False) -> Dict[str, int]:
    """Drive the mixed smoke workload over real HTTP and assert on it.

    Two same-bucket decomposes (the second must be a warm hit), a
    different-config decompose (second pool), cut and nuclei queries, one
    update delta (live version bump) and a status fetch validated against
    the schema.  Raises ``SystemExit`` on any violated invariant.  The
    client's graphs are made on the host and sent as edge lists; the
    server runs them on its own device."""
    import urllib.request

    from ..graph import generators
    from ..serve import STATUS_FORMAT, validate_status

    def call(route: str, payload: Optional[Dict] = None) -> Dict:
        url = f"http://{host}:{port}{route}"
        if payload is None:
            req = urllib.request.Request(url)
        else:
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    def edges_of(g) -> List[List[int]]:
        return g.edges.numpy().tolist()

    def check(cond: bool, what: str) -> None:
        if not cond:
            raise SystemExit(f"server selftest failed: {what}")

    # sizes drift but stay inside one power-of-two shape class, so the
    # second decompose MUST hit warm
    g0 = generators.planted_cliques(120, [10, 8, 6], 0.03, seed=3,
                                    device="cpu")
    g1 = generators.planted_cliques(122, [10, 8, 6], 0.03, seed=4,
                                    device="cpu")
    a0 = call("/decompose", {"n": g0.n, "edges": edges_of(g0),
                             "r": 2, "s": 3, "artifact": "alpha"})
    a1 = call("/decompose", {"n": g1.n, "edges": edges_of(g1),
                             "r": 2, "s": 3, "artifact": "beta"})
    # a second tenant config -> a second router pool
    a2 = call("/decompose", {"n": g0.n, "edges": edges_of(g0),
                             "r": 1, "s": 2, "artifact": "gamma"})
    for name, art in (("alpha", a0), ("beta", a1), ("gamma", a2)):
        check(art["artifact"] == name and art["version"] == 0,
              f"decompose reply for {name!r}: {art}")
        check(art["plan"] and "backend" in art["plan"],
              f"decompose reply for {name!r} lacks an embedded plan")
    cut = call("/query", {"artifact": "alpha", "kind": "cut", "c": 1})
    check(len(cut["cut"]) == a0["n_r"], "cut length != n_r")
    nuc = call("/query", {"artifact": "beta", "kind": "nuclei", "c": 1})
    check(len(nuc["nuclei"]) >= 1, "no nuclei at c=1")
    upd = call("/update", {"artifact": "alpha",
                           "insert": [[0, int(g0.n - 1)]]})
    check(upd["version"] == 1, f"update did not bump version: {upd}")
    status = validate_status(call("/status"))
    check(status["format"] == STATUS_FORMAT, "bad status format")
    warm = sum(p["stats"]["warm"] for p in status["pools"])
    check(warm >= 1, f"expected >=1 warm hit after same-bucket pair, "
                     f"got {warm}")
    check(len(status["pools"]) == 2,
          f"expected 2 pools (two tenant configs), "
          f"got {len(status['pools'])}")
    check(status["artifacts"]["alpha"]["version"] == 1,
          "status does not show the updated live version")
    check(status["frontend"]["served"] >= 4, "served counter too low")
    out = {"decomposes": 3, "queries": 2, "updates": 1,
           "warm_hits": warm, "pools": len(status["pools"])}
    if not quiet:
        print(f"selftest ok: {out}")
    return out


def serve_nucleus_server(port: int = 0, cache_dir: str = "",
                         selftest: bool = False, max_queue: int = 64,
                         quiet: bool = False, device: DeviceLike = None):
    """The multi-tenant server.

    Builds the Router -> Frontend -> HTTP stack on ``device``.  With
    ``cache_dir`` it first points the kernel build there and, if a session
    manifest from a previous run exists, pre-warms the pools, so the first
    same-bucket decompose after a restart is warm; on shutdown the
    manifest is (re)saved.  ``selftest`` drives the mixed smoke workload
    over HTTP and returns its stats (plus ``prewarmed``); without it the
    server blocks until SIGINT.
    """
    from ..serve import (Frontend, NucleusHTTPServer, Router,
                         init_persistent_cache, load_manifest,
                         prewarm_router, save_manifest)

    dev = resolve_device(device)
    router = Router(device=dev)
    prewarmed = 0
    if cache_dir:
        init_persistent_cache(cache_dir)
        manifest = load_manifest(cache_dir)
        if manifest is not None:
            prewarmed = prewarm_router(router, manifest)
    frontend = Frontend(router, max_queue=max_queue)
    server = NucleusHTTPServer(frontend, port=port)
    host, bound = server.start()
    if not quiet:
        print(f"nucleus server ({dev.type}) on http://{host}:{bound} "
              f"({prewarmed} bucket(s) pre-warmed"
              f"{' from ' + cache_dir if cache_dir else ''})")
    try:
        if selftest:
            out = _selftest_workload(host, bound, quiet=quiet)
            out["prewarmed"] = prewarmed
            return out
        while True:  # pragma: no cover - interactive serving loop
            time.sleep(1.0)
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        server.stop()
        if cache_dir:
            save_manifest(router, cache_dir)
            if not quiet:
                print(f"session manifest saved to {cache_dir}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain path)")
    ap.add_argument("--decomposition", default="",
                    help="path to a serialized Decomposition JSON "
                         "(--arch nucleus); omitted = inline offline stage")
    ap.add_argument("--queries", type=int, default=64,
                    help="number of nucleus queries (--arch nucleus); "
                         "0 is honored (no query stage, percentiles None)")
    ap.add_argument("--warm-pool", action="store_true",
                    help="--arch nucleus: decompose a stream of graphs "
                         "through the plan-aware router (per-config "
                         "Session pools) instead of serving one artifact")
    ap.add_argument("--pool-graphs", type=int, default=5,
                    help="graphs in the warm pool (--warm-pool)")
    ap.add_argument("--bucket-cap", type=int, default=0,
                    help="LRU cap on each Session's tracked shape buckets "
                         "(--warm-pool); 0 = the Session default")
    ap.add_argument("--r", default="2",
                    help="nucleus r; comma list for mixed tenant configs "
                         "(--warm-pool)")
    ap.add_argument("--s", default="3",
                    help="nucleus s; comma list for mixed tenant configs "
                         "(--warm-pool)")
    ap.add_argument("--method", default="exact",
                    help="exact|approx; comma list for mixed tenant "
                         "configs (--warm-pool)")
    ap.add_argument("--server", action="store_true",
                    help="--arch nucleus: start the multi-tenant HTTP "
                         "server (Frontend + admission control)")
    ap.add_argument("--port", type=int, default=0,
                    help="--server port (0 = ephemeral)")
    ap.add_argument("--cache-dir", default="",
                    help="--server: kernel build cache + session manifest "
                         "directory (restart warm path)")
    ap.add_argument("--selftest", action="store_true",
                    help="--server: drive the mixed smoke workload over "
                         "HTTP, assert the status schema, and exit")
    args = ap.parse_args()
    if args.arch == "nucleus":
        if args.server:
            serve_nucleus_server(port=args.port, cache_dir=args.cache_dir,
                                 selftest=args.selftest, device=args.device)
        elif args.warm_pool:
            serve_nucleus_warm_pool(n_graphs=args.pool_graphs,
                                    n_queries=args.queries // max(
                                        args.pool_graphs, 1),
                                    bucket_cap=args.bucket_cap,
                                    r=args.r, s=args.s, method=args.method,
                                    device=args.device)
        else:
            serve_nucleus(path=args.decomposition, n_queries=args.queries,
                          device=args.device)
    else:
        serve_lm(args.arch, n_requests=args.requests, device=args.device)


if __name__ == "__main__":
    main()
