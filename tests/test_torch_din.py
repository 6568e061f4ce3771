"""The port's DIN slice (``repro_torch.models.din``, ``configs.din``,
``launch.steps``' din steps, ``train_din`` and ``serve_din``) against the
reference, on the CPU.

The same numpy inputs go through both: parameters drawn with numpy at the
reference's names, shapes and dtypes (``jax.eval_shape`` of its
``init_params``), carried across by ``tree.params_from_reference``; the
reference's ``train_din``/``serve_din`` draw theirs through
``init_params``, so the test hands them the same ones there.  The
reference's functions are jitted once per config and shape.  Everything is
float32 at the smoke widths; tolerances are stated per test.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data import RecsysStream as JRecsysStream
from repro.data import RecsysStreamConfig as JRecsysStreamConfig
from repro.launch import serve as jserve
from repro.launch import steps as JS
from repro.launch import train as jtrain
from repro.models import din as JD
from repro.optim import adamw as JA
from repro_torch.configs import din as din_configs
from repro_torch.configs import get_arch
from repro_torch.launch import serve, steps as S, train
from repro_torch.models import din as D
from repro_torch.optim import adamw as A
from repro_torch.tree import flatten_with_paths, params_from_reference

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

J_OPT = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
OPT = A.AdamWConfig(**dataclasses.asdict(J_OPT))
B = 24


def t(a):
    return torch.from_numpy(np.asarray(a))


def on_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def on_torch(b):
    return {k: t(v) for k, v in b.items()}


def j_params(jc, seed=0):
    """numpy parameters at the reference's names, shapes and dtypes:
    N(0, 1) table rows (the reference draws 0.01: larger rows exercise the
    attention), N(0, 1/fan_in) matrices and N(0, 0.1^2) biases."""
    shapes = jax.eval_shape(functools.partial(JD.init_params, cfg=jc),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        scale = (1.0 if name.endswith("table") else
                 1.0 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.1)
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def smoke():
    jc = j_get_arch("din").make_smoke_config()
    jp = j_params(jc)
    return jc, get_arch("din").make_smoke_config(), jp


def batch(cfg, rows=B, seed=0):
    """A RecsysStream batch: histories with padded tails (-1 ids)."""
    return JRecsysStream(JRecsysStreamConfig(
        n_items=cfg.n_items, n_cates=cfg.n_cates, n_users=cfg.n_user_feats,
        seq_len=cfg.seq_len, batch=rows, seed=seed)).batch(0)


def features(b):
    return {k: v for k, v in b.items() if k != "label"}


# the reference's functions compiled once per config and shape
j_forward = jax.jit(JD.forward, static_argnums=2)
j_score = jax.jit(JD.score_candidates, static_argnums=2)
j_train_step = jax.jit(JS.din_train_step, static_argnums=(3, 4))
j_serve_step = jax.jit(JS.din_serve_step, static_argnums=2)
j_bag = jax.jit(JD.embedding_bag, static_argnums=(3, 4))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_and_cells_match_reference():
    """Full and smoke configs field for field (dtype aside), the four
    cells, and the retrieval cell's padding to a multiple of 512."""
    jspec, spec = j_get_arch("din"), get_arch("din")
    assert spec.family == jspec.family == "recsys"
    for which in ("make_config", "make_smoke_config"):
        jc, tc = getattr(jspec, which)(), getattr(spec, which)()
        assert {k: v for k, v in jc.__dict__.items() if k != "dtype"} == \
            {k: v for k, v in tc.__dict__.items() if k != "dtype"}
        assert tc.dtype == torch.float32
    assert [(c.name, c.kind, c.dims) for c in spec.shapes] == \
        [(c.name, c.kind, c.dims) for c in jspec.shapes]
    cell = spec.shape("retrieval_cand")
    want = jspec.input_specs(jspec.make_config(),
                             jspec.shape("retrieval_cand"))
    assert din_configs.n_candidates_padded(cell) == 1_000_448 == \
        want["batch"]["cand_items"].shape[0]


# ---------------------------------------------------------------------------
# the EmbeddingBag substrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference_and_loop(mode):
    """Ragged bags with an empty bag and padding ids (-1, zero rows): equal
    to the reference's and to a loop over the bags."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = np.array([3, 4, 7, 0, -1, 2, 9, 9, -1], np.int32)
    offsets = np.array([0, 3, 3, 5, 8], np.int32)  # [0:3) [3:3) [3:5) ...
    got = D.embedding_bag(t(table), t(ids), t(offsets), 5, mode).numpy()
    want = np.asarray(j_bag(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(offsets), 5, mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    bounds = list(offsets) + [len(ids)]
    loop = np.zeros((5, 8), np.float32)
    for i in range(5):
        bag = [x for x in ids[bounds[i]:bounds[i + 1]]]
        rows = [table[x] for x in bag if x >= 0]
        if rows:
            loop[i] = np.sum(rows, 0) / (len(rows) if mode == "mean" else 1)
    np.testing.assert_allclose(got, loop, rtol=1e-6, atol=1e-6)


def test_embedding_lookup_pads_with_zero_rows():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1
    ids = torch.tensor([[2, -1], [0, 3]], dtype=torch.int32)
    got = D.embedding_lookup(table, ids)
    assert got.shape == (2, 2, 3)
    assert torch.equal(got[0, 1], torch.zeros(3))
    assert torch.equal(got[1, 1], table[3])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_matches_reference():
    """CTR logits of a padded RecsysStream batch at rtol 1e-5."""
    jc, tc, jp = smoke()
    b = features(batch(tc))
    assert (b["hist_items"] < 0).any()
    want = j_forward(jp, on_jax(b), jc)
    got = D.forward(params_from_reference(jp, "cpu"), on_torch(b), tc)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("chunk", [3, D.RETRIEVAL_CHUNK])
def test_score_candidates_equals_forward_and_reference(chunk, monkeypatch):
    """One user's history against 10 candidates, ``chunk`` at a time (3: a
    ragged last chunk): each score equals ``forward`` of that candidate,
    and the reference's ``score_candidates`` at rtol 1e-5."""
    monkeypatch.setattr(D, "RETRIEVAL_CHUNK", chunk)
    jc, tc, jp = smoke()
    tp = params_from_reference(jp, "cpu")
    rng = np.random.default_rng(3)
    hist = rng.integers(0, tc.n_items, tc.seq_len).astype(np.int32)
    hist[-4:] = -1
    cands = rng.integers(0, tc.n_items, 10).astype(np.int32)
    rb = {"hist_items": hist,
          "hist_cates": np.where(hist >= 0, hist % tc.n_cates, -1).astype(
              np.int32),
          "user_id": np.asarray(7, np.int32),
          "cand_items": cands, "cand_cates": cands % tc.n_cates}
    got = D.score_candidates(tp, on_torch(rb), tc)
    fb = {"hist_items": np.tile(rb["hist_items"], (10, 1)),
          "hist_cates": np.tile(rb["hist_cates"], (10, 1)),
          "cand_item": cands, "cand_cate": rb["cand_cates"],
          "user_id": np.full(10, 7, np.int32)}
    fwd = D.forward(tp, on_torch(fb), tc)
    np.testing.assert_allclose(got.numpy(), fwd.numpy(), rtol=1e-6,
                               atol=1e-7)
    want = j_score(jp, on_jax(rb), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(S.din_retrieval_step(tp, on_torch(rb), tc),
                       D.score_candidates(tp, on_torch(rb), tc))


def test_chunked_scores_equal_unchunked(monkeypatch):
    """Chunks of 1, 4 and all 37 candidates give equal scores row for
    row."""
    _, tc, jp = smoke()
    tp = params_from_reference(jp, "cpu")
    rng = np.random.default_rng(5)
    cands = rng.integers(0, tc.n_items, 37).astype(np.int32)
    hist = rng.integers(0, tc.n_items, tc.seq_len).astype(np.int32)
    rb = on_torch({"hist_items": hist, "hist_cates": hist % tc.n_cates,
                   "user_id": np.asarray(1, np.int32), "cand_items": cands,
                   "cand_cates": cands % tc.n_cates})
    scores = {}
    for chunk in (37, 1, 4):
        monkeypatch.setattr(D, "RETRIEVAL_CHUNK", chunk)
        scores[chunk] = D.score_candidates(tp, rb, tc).numpy()
    for chunk in (1, 4):
        np.testing.assert_allclose(scores[chunk], scores[37], rtol=1e-6,
                                   atol=1e-7)


def test_padding_ignored():
    """What stands behind a -1 history id changes nothing: the category
    there, and a history one longer with its extra item padded."""
    _, tc, jp = smoke()
    tp = params_from_reference(jp, "cpu")
    b = features(batch(tc, rows=4, seed=2))
    b["hist_items"][:, -3:] = -1
    b2 = dict(b, hist_cates=np.where(b["hist_items"] >= 0, b["hist_cates"],
                                     7).astype(np.int32))
    o1 = D.forward(tp, on_torch(b), tc)
    o2 = D.forward(tp, on_torch(b2), tc)
    np.testing.assert_array_equal(o1.numpy(), o2.numpy())


# ---------------------------------------------------------------------------
# the steps and the launchers
# ---------------------------------------------------------------------------

def test_din_train_step_matches_reference():
    """One ``din_train_step``: loss at rtol 1e-5, grad_norm, lr, the
    moments, and the params with atol lr/1000."""
    jc, tc, jp = smoke()
    b = batch(tc)
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), jp)
    jstate = JA.AdamWState(step=np.zeros((), np.int32), mu=zeros,
                           nu=jax.tree.map(np.copy, zeros))
    jp2, js2, jm = j_train_step(jp, jstate, on_jax(b), jc, J_OPT)
    tp = params_from_reference(jp, "cpu")
    tp2, ts2, tm = S.din_train_step(tp, A.init_state(tp), on_torch(b), tc,
                                    OPT)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    for what, got, want, atol in (("mu", ts2.mu, js2.mu, 1e-8),
                                  ("params", tp2, jp2, J_OPT.lr / 1000)):
        w = dict(flatten_with_paths(jax.device_get(want)))
        g = dict(flatten_with_paths(got))
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-4 if what == "mu" else 0,
                                       atol=atol, err_msg=f"{what} {k}")


def test_din_serve_step_matches_reference():
    jc, tc, jp = smoke()
    b = features(batch(tc, seed=1))
    want = j_serve_step(jp, on_jax(b), jc)
    got = S.din_serve_step(params_from_reference(jp, "cpu"), on_torch(b), tc)
    assert ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def _same_init(monkeypatch):
    """Both packages' ``init_params`` return the same smoke weights."""
    jc, tc, jp = smoke()

    def j_init(key, cfg):
        assert cfg == jc
        return jax.tree.map(jnp.asarray, jp)

    def t_init(cfg, generator=None, device=None):
        assert cfg == tc
        return params_from_reference(jp, device)
    monkeypatch.setattr(JD, "init_params", j_init)
    monkeypatch.setattr(D, "init_params", t_init)


def test_train_din_matches_reference(monkeypatch):
    """Four steps of ``train_din`` at the smoke config: the losses equal
    the reference's at rtol 1e-5."""
    _same_init(monkeypatch)
    want = jtrain.train_din(steps=4, batch=16, quiet=True)
    got = train.train_din(steps=4, batch=16, quiet=True, device="cpu")
    assert got.steps_done == want.steps_done == 4
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)


def test_serve_din_matches_reference(monkeypatch):
    """``serve_din``'s CTR probabilities equal the reference's at rtol
    1e-5, batch for batch."""
    _same_init(monkeypatch)
    want = jserve.serve_din(n_batches=2, batch=16, quiet=True)
    got = serve.serve_din(n_batches=2, batch=16, quiet=True, device="cpu")
    assert got.shape == want.shape == (32,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_din_lanes_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: train.train_din(steps=1, quiet=True),
                 lambda: serve.serve_din(n_batches=1, quiet=True),
                 lambda: D.init_params(get_arch("din").make_smoke_config())):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
