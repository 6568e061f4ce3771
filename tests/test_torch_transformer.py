"""The port's dense transformer (``repro_torch.models.transformer``) and
LM configs against the reference's, on the CPU.

The same numpy inputs, and numpy parameters at the reference's names,
shapes and scales carried across by ``params_from_reference``, go through
both.  Everything is float32 at
smoke widths; tolerances are stated per test (float32 sums in another
order than XLA's).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCH_IDS as J_ALL_ARCH_IDS
from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro_torch.configs import ALL_ARCH_IDS, get_arch
from repro_torch.kernels import launch_counts
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

ARCHS = ("minicpm-2b", "minitron-4b", "stablelm-12b")
MOE_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-lite-16b")
# the reference's sharding/cost hints: no counterpart on one device
REFERENCE_ONLY = ("cost_unroll", "moe_ep_data", "act_specs")
_JDT = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def t(a):
    return torch.from_numpy(np.asarray(a))


# the reference's functions compiled whole: eager JAX compiles op by op,
# which costs seconds per config on the CPU
j_forward = jax.jit(JT.forward, static_argnums=2)
j_decode = jax.jit(JT.decode_step, static_argnums=4)
j_rmsnorm = jax.jit(JT.rmsnorm, static_argnums=2)
j_online = jax.jit(JT.online_attention, static_argnames=("causal", "chunk",
                                                         "unroll"))


def ref_shapes(jc):
    """The reference's parameter leaves as shapes (``jax.eval_shape`` of
    its ``init_params``: traced, never compiled)."""
    return jax.eval_shape(functools.partial(JT.init_params, cfg=jc),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def j_params(jc, seed=0):
    """numpy parameters at the reference's names, shapes, dtypes and scales
    (unit norms and embedding rows, 1/sqrt(fan_in) weights, as its
    ``_dense`` draws them), from ``np.random.default_rng(seed)``; read,
    never written."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name.startswith("ln"):
            a = np.ones(s.shape, np.float32)
        else:
            scale = 1.0 if name == "embed" else 1.0 / np.sqrt(s.shape[-2])
            a = (rng.standard_normal(s.shape) * scale).astype(np.float32)
        return a.astype(s.dtype)
    return jax.tree_util.tree_map_with_path(draw, ref_shapes(jc))


def smoke_pair(arch):
    return j_get_arch(arch).make_smoke_config(), get_arch(arch).make_smoke_config()


def test_registry_has_the_dense_archs_only():
    """The registry equals the reference's: the five LM archs (the three
    dense ones, the MoE moonshot-v1-16b-a3b and the MoE + MLA
    deepseek-v2-lite-16b; their parity: tests/test_torch_moe_mla.py), the
    four GNN archs and din, and the nucleus workload's config
    (``configs.nucleus``).  The ten assigned archs have four cells each:
    40, as the reference counts them."""
    assert ALL_ARCH_IDS == J_ALL_ARCH_IDS
    assigned = set(ALL_ARCH_IDS) - {"nucleus"}
    assert set(ARCHS + MOE_ARCHS) <= assigned and len(assigned) == 10
    assert sum(len(get_arch(a).shapes) for a in assigned) == 40


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
@pytest.mark.parametrize("which", ["make_config", "make_smoke_config"])
def test_config_fields_match_reference(arch, which):
    jc = getattr(j_get_arch(arch), which)()
    tc = getattr(get_arch(arch), which)()
    names = [f.name for f in dataclasses.fields(tc)]
    assert names == [f.name for f in dataclasses.fields(jc)
                     if f.name not in REFERENCE_ONLY]
    for name in names:
        a, b = getattr(tc, name), getattr(jc, name)
        if name == "dtype":
            assert a == _JDT[b]
        elif name in ("moe", "mla") and b is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        else:
            assert a == b, name
    assert tc.head_dim == jc.head_dim
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert [dataclasses.astuple(c) for c in get_arch(arch).shapes] == \
        [dataclasses.astuple(c) for c in j_get_arch(arch).shapes]


def _port_config(jc):
    """The reference's config as the port's, MoE/MLA parts included."""
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
          if f.name not in REFERENCE_ONLY}
    kw["dtype"] = _JDT[jc.dtype]
    if jc.moe is not None:
        kw["moe"] = T.MoEConfig(**dataclasses.asdict(jc.moe))
    if jc.mla is not None:
        kw["mla"] = T.MLAConfig(**dataclasses.asdict(jc.mla))
    return T.TransformerConfig(**kw)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mla_configs_count_and_raise(arch):
    """MoE/MLA configs build with the reference's parameter counts, and
    every model function runs on the smoke config: init_params,
    init_cache, forward and a decode step give finite values of the
    expected shapes (their parity with the reference:
    tests/test_torch_moe_mla.py)."""
    for which in ("make_config", "make_smoke_config"):
        jc = getattr(j_get_arch(arch), which)()
        tc = _port_config(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc._attn_params() == jc._attn_params()
    toks = torch.zeros((1, 4), dtype=torch.int64)
    params = T.init_params(tc, device="cpu")
    cache = T.init_cache(tc, 1, 4, device="cpu")
    assert len(cache) == 2 and all(c.shape[:3] == (tc.n_layers, 1, 4)
                                   for c in cache)
    logits = T.forward(params, toks, tc)
    assert logits.shape == (1, 4, tc.vocab)
    step, cache, n = T.decode_step(params, toks, cache, 0, tc)
    assert n == 4 and step.shape == (1, 4, tc.vocab)
    assert bool(torch.isfinite(logits).all() and torch.isfinite(step).all())
    torch.testing.assert_close(step, logits, rtol=1e-4, atol=1e-4)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    s = rng.standard_normal(24).astype(np.float32)
    want = j_rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5)
    got = T.rmsnorm(t(x), t(s), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # bf16 activations: the norm runs in f32 and casts back, as there
    xb = t(x).to(torch.bfloat16)
    gb = T.rmsnorm(xb, t(s).to(torch.bfloat16), 1e-5)
    wb = j_rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16),
                   1e-5)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(wb, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_rope_interleaved_pairs_match_reference():
    """Angles and rotation equal the reference's; pairs are (0::2, 1::2),
    not the half-split rotate_half convention."""
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 7, 3, 16
    pos = rng.integers(0, 2000, (B, S)).astype(np.int32)
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    jc, js = JT.rope_angles(jnp.asarray(pos), D, 10_000.0)
    c, s = T.rope_angles(t(pos), D, 10_000.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-5)
    got = T.apply_rope(t(x), c, s).numpy()
    want = np.asarray(JT.apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the convention itself, from numpy
    cn, sn = c.numpy()[:, :, None, :], s.numpy()[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    np.testing.assert_allclose(got[..., 0::2], x1 * cn - x2 * sn, atol=1e-5)
    np.testing.assert_allclose(got[..., 1::2], x2 * cn + x1 * sn, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 4)])
def test_online_attention_offsets_valid_len_gqa(causal, H, Hkv):
    """Queries at an offset into a padded cache: k_valid_len < Sk masks the
    tail, per batch row; chunk 8 over 21 slots leaves a ragged chunk."""
    rng = np.random.default_rng(2)
    B, Sq, Sk, D = 2, 3, 21, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    pos = np.stack([9 + np.arange(Sq), 14 + np.arange(Sq)]).astype(np.int32)
    valid = np.array([12, 17], np.int32)
    want = j_online(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(pos), jnp.asarray(valid), causal=causal,
                    chunk=8)
    got = T.online_attention(t(q), t(k), t(v), t(pos), t(valid),
                             causal=causal, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_init_params_names_shapes_dtypes(arch):
    """The smoke configs' leaves have the reference's paths, shapes, dtypes
    and scales (the MoE router float32; full width:
    tests/test_torch_moe_mla.py)."""
    jc, tc = smoke_pair(arch)
    jp = ref_shapes(jc)
    tp = T.init_params(tc, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
    # the reference's scales: unit embedding rows, 1/sqrt(fan_in) weights
    assert abs(float(tp["embed"].std()) - 1.0) < 0.1
    w1 = tp["layers"]["w1"]
    assert abs(float(w1.std()) * np.sqrt(w1.shape[-2]) - 1.0) < 0.1
    assert torch.equal(tp["layers"]["ln1"], torch.ones_like(tp["layers"]["ln1"]))
    if tc.moe is not None:
        assert tp["layers"]["router"].dtype == torch.float32
        for name in ("w2", "router", "sw1", "w_uk"):
            w = tp["layers"].get(name)
            if w is not None:
                assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1) < 0.15


def test_params_from_reference_bf16_exact():
    """bf16 leaves cross through float32 without changing a value."""
    jc = j_get_arch("minicpm-2b").make_smoke_config()
    jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
    tc = dataclasses.replace(get_arch("minicpm-2b").make_smoke_config(),
                             dtype=torch.bfloat16)
    jp = j_params(jc)
    tp = T.params_from_reference(jp, tc, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"]["wq"].float().numpy(),
                                  np.asarray(jp["layers"]["wq"], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Logits of the smoke config, reference weights; the port's prefill
    attention is the flash-attention plain twin on the CPU, the
    reference's the online scan (equal functions).  rtol/atol 1e-4: f32
    through two layers and a 512-way unembedding."""
    jc, tc = smoke_pair(arch)
    jp = j_params(jc)
    tp = T.params_from_reference(jp, tc, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tc.vocab, (2, 37)).astype(np.int32)
    want = np.asarray(j_forward(jp, jnp.asarray(toks), jc))
    before = launch_counts["flash_attention"]
    got = T.forward(tp, t(toks), tc).numpy()
    assert launch_counts["flash_attention"] == before  # CPU: plain twin
    assert got.shape == (2, 37, tc.vocab)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["minicpm-2b", "minitron-4b"])
def test_prefill_then_decode_matches_reference(arch):
    """init_cache, a 5-token step into the cache, then three 1-token
    steps: logits and the whole cache equal the reference's each step
    (the port writes its cache in place)."""
    jc, tc = smoke_pair(arch)
    jp = j_params(jc)
    tp = T.params_from_reference(jp, tc, device="cpu")
    rng = np.random.default_rng(6)
    B, max_len = 3, 12
    jcache = JT.init_cache(jc, B, max_len)
    tcache = T.init_cache(tc, B, max_len, device="cpu")
    assert tcache[0].shape == jcache[0].shape
    jlen, tlen = jnp.zeros((), jnp.int32), 0
    for S in (5, 1, 1, 1):
        toks = rng.integers(0, tc.vocab, (B, S)).astype(np.int32)
        jlog, jcache, jlen = j_decode(jp, jnp.asarray(toks), jcache,
                                            jlen, jc)
        tlog, tcache, tlen = T.decode_step(tp, t(toks), tcache, tlen, tc)
        assert tlen == int(jlen)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-4)
        for a, b in zip(tcache, jcache):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


def test_decode_step_refuses_cache_overflow():
    tc = get_arch("minicpm-2b").make_smoke_config()
    tp = T.init_params(tc, device="cpu")
    cache = T.init_cache(tc, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="cannot take"):
        T.decode_step(tp, torch.zeros((1, 3), dtype=torch.int64), cache, 2,
                      tc)
