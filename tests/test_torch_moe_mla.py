"""The port's MoE FFN and MLA attention (``repro_torch.models.transformer``)
and the two archs that use them, moonshot-v1-16b-a3b (MoE) and
deepseek-v2-lite-16b (MoE + MLA), against the reference on the CPU.

The same numpy inputs go through both: parameters are drawn with numpy at
the reference's shapes and scales (``jax.eval_shape`` of its
``init_params``, so its init is never compiled) and fed to the reference's
jitted functions and to the port.  Everything is float32 at smoke widths;
the tolerances are stated per test.  The capacity drops are compared
exactly: the outputs are equal where an entry drops, so the port drops the
reference's entries.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.models.transformer import MLAConfig as JMLA, MoEConfig as JMoE
from repro_torch.configs import get_arch
from repro_torch.kernels import launch_counts
from repro_torch.models import transformer as T
from test_torch_transformer import _port_config as port_config
from test_torch_transformer import j_params as np_params, ref_shapes, t

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-lite-16b")
# the reference's functions compiled once per shape
j_forward = jax.jit(JT.forward, static_argnums=2)
j_decode = jax.jit(JT.decode_step, static_argnums=4)
j_moe = jax.jit(JT.moe_block, static_argnums=2)


def _variant(name):
    """tests/test_models.py::test_decode_matches_forward's configs."""
    moe = JMoE(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1,
               capacity_factor=4.0)
    mla = JMLA(kv_lora_rank=12, rope_head_dim=4)
    kw = {"moe": dict(moe=moe), "mla": dict(n_kv_heads=4, mla=mla),
          "moe_mla": dict(n_kv_heads=4, moe=moe, mla=mla)}[name]
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=53, attn_chunk=8, dtype=jnp.float32,
                remat=False)
    base.update(kw)
    return JT.TransformerConfig(**base)


CONFIGS = {**{a: j_get_arch(a).make_smoke_config() for a in ARCHS},
           **{v: _variant(v) for v in ("moe", "mla", "moe_mla")}}


def pair(name, seed=0):
    jc = CONFIGS[name]
    tc = port_config(jc)
    jp = np_params(jc, seed)
    return jc, tc, jp, T.params_from_reference(jp, tc, device="cpu")


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["make_config", "make_smoke_config"])
def test_init_params_full_width_shapes_and_count(arch, which, monkeypatch):
    """The port's leaves have the reference's paths, shapes and dtypes at
    full width (2.9·10^10 and 1.6·10^10 parameters, the router float32 in
    the bf16 configs), where both sides are shapes only: the reference
    through ``jax.eval_shape``, the port with its draws made on the meta
    device.  At both widths the leaves sum to ``param_count`` less the
    reference's MLA over-count (the smoke configs' scales:
    tests/test_torch_transformer.py)."""
    jc = getattr(j_get_arch(arch), which)()
    tc = getattr(get_arch(arch), which)()
    want = ref_shapes(jc)
    monkeypatch.setattr(T, "_dense", lambda gen, shape, dtype, device,
                        scale=None: torch.empty(shape, dtype=dtype,
                                                device="meta"))
    got = T.init_params(tc, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
    assert got["layers"]["router"].dtype == torch.float32
    # the reference's param_count counts w_uk as r x H*D; its leaf is
    # r x H*(D - pr)
    n = sum(int(np.prod(a.shape)) for _, a in jl)
    over = 0 if tc.mla is None else tc.n_layers * tc.mla.kv_lora_rank * \
        tc.n_heads * tc.mla.rope_head_dim
    assert n == tc.param_count() - over == jc.param_count() - over


def test_dense_draws_in_chunks(monkeypatch):
    """A tensor over ``DRAW_CHUNK`` samples is drawn chunk by chunk into a
    preallocated tensor of its dtype, at the asked scale."""
    monkeypatch.setattr(T, "DRAW_CHUNK", 1000)
    gen = torch.Generator().manual_seed(0)
    w = T._dense(gen, (3, 50, 41), torch.bfloat16, "cpu")
    assert w.dtype == torch.bfloat16 and w.shape == (3, 50, 41)
    assert abs(float(w.float().std()) * np.sqrt(50) - 1) < 0.05
    # chunks continue the generator's stream: no chunk repeats another
    flat = w.float().flatten()
    assert not torch.equal(flat[:1000], flat[1000:2000])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_exact_in_bf16(arch):
    """bf16 leaves cross exactly; the router stays float32."""
    jc = dataclasses.replace(j_get_arch(arch).make_smoke_config(),
                             dtype=jnp.bfloat16)
    tc = port_config(jc)
    jp = np_params(jc)
    assert jp["layers"]["w1"].dtype == ml_dtypes.bfloat16
    tp = T.params_from_reference(jp, tc, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = dict((jax.tree_util.keystr(p), b) for p, b in
              jax.tree_util.tree_leaves_with_path(tp))
    for path, a in jl:
        b = tl[jax.tree_util.keystr(path)]
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["w_dkv" if jc.mla else "w1"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

def moe_inputs(seed, T_, d, E, f, n_shared=0, scale=1.0):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * scale,
         "w1": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2,
         "w2": rng.standard_normal((E, f, d)).astype(np.float32) * 0.2,
         "w3": rng.standard_normal((E, d, f)).astype(np.float32) * 0.2}
    if n_shared:
        for k, shape in (("sw1", (d, f * n_shared)), ("sw2", (f * n_shared, d)),
                         ("sw3", (d, f * n_shared))):
            p[k] = rng.standard_normal(shape).astype(np.float32) * 0.2
    x = rng.standard_normal((T_, d)).astype(np.float32)
    return x, p


def both_moe(x, p, jcfg):
    want = np.asarray(j_moe(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                             p.items()}, jcfg))
    got = T.moe_block(t(x), {k: t(v) for k, v in p.items()},
                      T.MoEConfig(**dataclasses.asdict(jcfg))).numpy()
    return got, want


@pytest.mark.parametrize("seed", range(6))
def test_moe_block_unconstrained_matches_reference(seed):
    """capacity_factor E/K: every expert has a slot for every token, so
    nothing drops; allclose 1e-5 (float32, sums in another order)."""
    cfg = JMoE(n_experts=4, top_k=2, d_ff_expert=16, n_shared=1,
               capacity_factor=2.0)
    x, p = moe_inputs(seed, 32, 8, 4, 16, n_shared=1)
    slot, keep = T.moe_slots(T.moe_route(t(x), t(p["router"]),
                                         T.MoEConfig(**dataclasses.asdict(
                                             cfg)))[1], 4,
                             T.moe_capacity(32, cfg))
    assert bool(keep.all())
    got, want = both_moe(x, p, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("K,n_shared", [(1, 0), (1, 2), (3, 0), (3, 2)])
def test_moe_block_top_k_and_shared_experts_match_reference(K, n_shared,
                                                            seed):
    """Top-1 and top-3 routing with no shared expert and with two, under
    capacity (cap = ceil(48 · K / 6 · 1.25)); allclose 1e-5 (float32)."""
    cfg = JMoE(n_experts=6, top_k=K, d_ff_expert=16, n_shared=n_shared,
               capacity_factor=1.25)
    x, p = moe_inputs(300 + seed, 48, 8, 6, 16, n_shared=n_shared)
    got, want = both_moe(x, p, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_moe_block_crafted_router_drops_like_reference():
    """tests/test_models.py::test_moe_drops_beyond_capacity with numpy
    inputs: every token picks expert 0, cap = ceil(16 · 1 / 2 · 0.5) = 4,
    so exactly the first 4 tokens (the stable sort's first) keep output."""
    cfg = JMoE(n_experts=2, top_k=1, d_ff_expert=8, n_shared=0,
               capacity_factor=0.5)
    d, n = 4, 16
    p = {"router": np.zeros((d, 2), np.float32),
         "w1": np.full((2, d, 8), 0.1, np.float32),
         "w2": np.full((2, 8, d), 0.1, np.float32),
         "w3": np.full((2, d, 8), 0.1, np.float32)}
    p["router"][:, 0] = 10.0
    x = (np.abs(np.random.default_rng(4).standard_normal((n, d))) +
         0.1).astype(np.float32)
    got, want = both_moe(x, p, cfg)
    nonzero = np.any(np.abs(got) > 1e-9, axis=1)
    assert int(nonzero.sum()) == 4
    assert nonzero[:4].all()
    np.testing.assert_array_equal(nonzero,
                                  np.any(np.abs(want) > 1e-9, axis=1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cf,cap", [(1.0, 1), (1.25, 2)])
@pytest.mark.parametrize("seed", range(12))
def test_moe_block_decode_sized_drops_match_reference(cf, cap, seed):
    """A decode step's call: T = 4 tokens, top-2 of 8 experts, cap 1 or 2,
    with a router that makes the tokens collide (a constant input feature
    favours three experts, whose 2·cap slots cannot take the 8
    assignments).  Entries drop; the outputs equal the reference's, so the
    same entries drop (allclose 1e-6)."""
    cfg = JMoE(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1,
               capacity_factor=cf)
    assert T.moe_capacity(4, cfg) == cap
    x, p = moe_inputs(100 + seed, 4, 16, 8, 16, n_shared=1, scale=0.3)
    x[:, 0] = 1.0
    p["router"][0, :3] += 4.0
    _, eidx = T.moe_route(t(x), t(p["router"]),
                          T.MoEConfig(**dataclasses.asdict(cfg)))
    _, keep = T.moe_slots(eidx, 8, cap)
    assert not bool(keep.all()), "no entry dropped: the case tests nothing"
    got, want = both_moe(x, p, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_moe_block_bf16_matches_reference(seed):
    """bf16 activations and experts with a float32 router, as the full
    configs run, under capacity (cap 20 of 64 tokens · 2 / 8 experts):
    the largest row's ||got - want|| / ||want|| stays under 3e-2, bf16's
    few roundings of 2^-8 (the observed gap is ~1e-2, one ulp), where a
    dropped or misrouted contribution moves a row by tens of percent."""
    cfg = JMoE(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
               capacity_factor=1.25)
    x, p = moe_inputs(200 + seed, 64, 32, 8, 32, n_shared=1)
    dt = {k: jnp.float32 if k == "router" else jnp.bfloat16 for k in p}
    want = np.asarray(j_moe(jnp.asarray(x, jnp.bfloat16),
                            {k: jnp.asarray(v, dt[k]) for k, v in p.items()},
                            cfg).astype(jnp.float32))
    tp = {k: t(v) if k == "router" else t(v).to(torch.bfloat16)
          for k, v in p.items()}
    got = T.moe_block(t(x).to(torch.bfloat16), tp,
                      T.MoEConfig(**dataclasses.asdict(cfg)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert rel.max() < 3e-2, rel.max()


@pytest.mark.parametrize("K", [1, 2, 3])
def test_moe_route_breaks_ties_toward_the_lower_index(K):
    """A zero router ties every expert: jax.lax.top_k takes the lowest
    indices first, and so must the port; a tie between two experts inside
    the top-k keeps the lower one first."""
    cfg = JMoE(n_experts=5, top_k=K, d_ff_expert=8)
    x = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    gate, eidx = T.moe_route(t(x), torch.zeros((4, 5)),
                             T.MoEConfig(**dataclasses.asdict(cfg)))
    jg, je = jax.lax.top_k(jax.nn.softmax(jnp.zeros((6, 5))), K)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(je))
    np.testing.assert_allclose(gate.numpy(), 1.0 / K, rtol=1e-6)
    # experts 3 and 1 tie above the rest: 1 comes first
    router = torch.zeros((4, 5))
    router[:, [1, 3]] = 0.5
    _, eidx = T.moe_route(torch.ones((1, 4)), router,
                          T.MoEConfig(**dataclasses.asdict(cfg)))
    assert eidx[0].tolist()[:2] == [1, 3][:K]


# ---------------------------------------------------------------------------
# forward, decode, prefill, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name):
    """Logits of the smoke configs and of the reference's decode-vs-forward
    variants; the port's prefill attention is the flash-attention plain
    twin on the CPU.  rtol/atol 1e-4: float32 through two layers and the
    unembedding (the observed gap is ~2e-6)."""
    jc, tc, jp, tp = pair(name)
    toks = np.random.default_rng(5).integers(0, tc.vocab, (2, 19)).astype(
        np.int32)
    want = np.asarray(j_forward(jp, jnp.asarray(toks), jc))
    before = launch_counts["flash_attention"]
    got = T.forward(tp, t(toks), tc).numpy()
    assert launch_counts["flash_attention"] == before  # CPU: plain twin
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_decode_matches_reference(name):
    """init_cache (MLA: the latent and the rope key), a 5-token step, then
    three 1-token steps: logits (rtol/atol 1e-4) and the whole cache
    (1e-5) equal the reference's each step; the port writes its cache in
    place."""
    jc, tc, jp, tp = pair(name)
    rng = np.random.default_rng(6)
    B, max_len = 3, 12
    jcache = JT.init_cache(jc, B, max_len)
    tcache = T.init_cache(tc, B, max_len, device="cpu")
    assert [c.shape for c in tcache] == [c.shape for c in jcache]
    jlen, tlen = jnp.zeros((), jnp.int32), 0
    for S in (5, 1, 1, 1):
        toks = rng.integers(0, tc.vocab, (B, S)).astype(np.int32)
        jlog, jcache, jlen = j_decode(jp, jnp.asarray(toks), jcache, jlen,
                                      jc)
        tlog, tcache, tlen = T.decode_step(tp, t(toks), tcache, tlen, tc)
        assert tlen == int(jlen)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
        for a, b in zip(tcache, jcache):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("name", ["mla", "moe_mla"])
def test_decode_refuses_mla_cache_overflow(name):
    _, tc, _, tp = pair(name)
    cache = T.init_cache(tc, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="cannot take"):
        T.decode_step(tp, torch.zeros((1, 3), dtype=torch.int64), cache, 2,
                      tc)
