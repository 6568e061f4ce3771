"""The port's LM serving (``repro_torch.launch``) against the reference's
``serve_lm`` and ``lm_prefill_step`` on the CPU.  Both sides get numpy
parameters at the reference's names, shapes and scales
(``test_torch_transformer.j_params``), carried across by
``params_from_reference``; the reference's ``serve_lm`` draws its own
through ``init_params``, so the test hands it the same ones there, and its
init is never compiled.  Greedy tokens must be equal: float32 smoke
configs, where a last-digit difference in the logits does not change an
argmax of these seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as T
from test_torch_transformer import j_params

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)


LM_ARCHS = ["minicpm-2b", "minitron-4b", "moonshot-v1-16b-a3b",
            "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_lm_tokens_match_reference(arch, monkeypatch):
    """Six requests in waves of four (one full wave, one of two), with the
    same parameters on both sides."""
    jc = j_get_arch(arch).make_smoke_config()
    jp = j_params(jc)

    def init_params(key, cfg):
        assert cfg == jc
        return jp
    monkeypatch.setattr(JT, "init_params", init_params)
    tp = T.params_from_reference(jp, get_arch(arch).make_smoke_config(),
                                 device="cpu")
    kw = dict(n_requests=6, batch_slots=4, prompt_len=8, gen_len=10,
              quiet=True)
    want = jserve.serve_lm(arch, **kw)
    before = launch_counts["flash_attention"]
    got = serve.serve_lm(arch, params=tp, device="cpu", **kw)
    assert launch_counts["flash_attention"] == before  # decode: the scan
    assert sorted(got) == sorted(want) == list(range(6))
    for r in want:
        np.testing.assert_array_equal(got[r], np.asarray(want[r]),
                                      err_msg=f"request {r}")


@pytest.mark.parametrize("arch", ["minicpm-2b", "minitron-4b",
                                  "stablelm-12b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_prefill_step_argmax_matches_reference(arch):
    jc = j_get_arch(arch).make_smoke_config()
    tc = get_arch(arch).make_smoke_config()
    jp = j_params(jc)
    tp = T.params_from_reference(jp, tc, device="cpu")
    toks = np.random.default_rng(7).integers(0, tc.vocab, (3, 21)).astype(
        np.int32)
    want = jax.jit(jsteps.lm_prefill_step, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jc)
    got = steps.lm_prefill_step(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_lm_unported_lanes_raise():
    """serve_lm serves the LM archs only: din is served by serve_din
    (tests/test_torch_din.py) and nucleus by its own lanes
    (tests/test_torch_serve.py)."""
    with pytest.raises(ValueError, match="serve_din"):
        serve.serve_lm("din", device="cpu")
    with pytest.raises(ValueError, match="serve_nucleus"):
        serve.serve_lm("nucleus", device="cpu")
    with pytest.raises(ValueError, match="no LM"):
        serve.serve_lm("gin-tu", device="cpu")
