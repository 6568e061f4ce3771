"""The port's LM serving (``repro_torch.launch``) against the reference's
``serve_lm`` and ``lm_prefill_step`` on the CPU, with the reference's own
parameters (``init_params(PRNGKey(0))``, as its ``serve_lm`` draws them)
carried across by ``params_from_reference``.  Greedy tokens must be equal:
float32 smoke configs, where a last-digit difference in the logits does
not change an argmax of these seeds.
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


def converted(arch, init=JT.init_params):
    jc = j_get_arch(arch).make_smoke_config()
    tc = get_arch(arch).make_smoke_config()
    jp = init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, T.params_from_reference(jax.device_get(jp), tc,
                                               device="cpu")


@pytest.mark.parametrize("arch", ["minicpm-2b", "minitron-4b"])
def test_serve_lm_tokens_match_reference(arch):
    """Six requests in waves of four (one full wave, one of two); the
    reference's serve_lm draws init_params(PRNGKey(0)) eagerly, so the
    port gets the same draw."""
    _, _, _, tp = converted(arch)
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
                                  "stablelm-12b"])
def test_prefill_step_argmax_matches_reference(arch):
    jc, tc, jp, tp = converted(arch, jax.jit(JT.init_params,
                                             static_argnums=1))
    toks = np.random.default_rng(7).integers(0, tc.vocab, (3, 21)).astype(
        np.int32)
    want = jax.jit(jsteps.lm_prefill_step, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jc)
    got = steps.lm_prefill_step(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_lm_unported_lanes_raise():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serve.serve_lm("din", device="cpu")
    # nucleus is ported, by its own lanes (tests/test_torch_serve.py)
    with pytest.raises(ValueError, match="serve_nucleus"):
        serve.serve_lm("nucleus", device="cpu")
