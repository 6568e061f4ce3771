"""The reference's and the port's ``lm_train_step`` side by side on the CPU.

Both start from the same numpy weights (``tests/test_torch_transformer.
j_params``) and take the same ``TokenStream`` batches: minicpm-2b cut to
4 layers at d_model 512 (8 heads of 64, d_ff 1,280, vocab 4,096), f32,
B = 2, S = 256, with ``chip_smoke.py`` phase 12's schedule (AdamW lr 2e-3,
WSD with a 1-step warmup, clip 1.0), six steps.  It prints both losses,
lrs and gradient norms per step and exits non-zero when a loss differs by
more than rtol 1e-5.  About 25 s on 4 CPU threads.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/lm_loss_rise_check.py
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.data import TokenStream, TokenStreamConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from test_torch_transformer import _port_config, j_params  # noqa: E402

RTOL = 1e-5
STEPS = 6


def main() -> int:
    torch.set_num_threads(4)
    jc = dataclasses.replace(
        j_get_arch("minicpm-2b").make_smoke_config(), n_layers=4,
        d_model=512, n_heads=8, n_kv_heads=8, d_ff=1280, vocab=4096,
        dtype=jnp.float32, attn_chunk=64, remat=False)
    tc = _port_config(jc)
    jp = j_params(jc)
    tp = T.params_from_reference(jp, tc, device="cpu")
    jo = JA.AdamWConfig(lr=2e-3, schedule="wsd", warmup_steps=1,
                        total_steps=STEPS)
    to = A.AdamWConfig(**dataclasses.asdict(jo))
    stream = TokenStream(TokenStreamConfig(vocab=jc.vocab, seq_len=256,
                                           global_batch=2, seed=0))
    jstep = jax.jit(JS.lm_train_step, static_argnums=(3, 4))
    jps = jax.tree.map(jnp.asarray, jp)
    jst, tst = JA.init_state(jps), A.init_state(tp)
    worst = 0.0
    for i in range(STEPS):
        b = stream.batch(i)
        jps, jst, jm = jstep(jps, jst, {k: jnp.asarray(v)
                                        for k, v in b.items()}, jc, jo)
        tp, tst, tm = S.lm_train_step(tp, tst, {k: torch.from_numpy(v)
                                                for k, v in b.items()},
                                      tc, to)
        jl, tl = float(jm["loss"]), float(tm["loss"])
        rel = abs(tl - jl) / abs(jl)
        worst = max(worst, rel)
        print(f"step {i}: reference loss {jl:.7f}, port loss {tl:.7f} "
              f"(rel {rel:.3g}); lr {float(jm['lr']):.3g} / "
              f"{float(tm['lr']):.3g}; grad_norm {float(jm['grad_norm']):.5f}"
              f" / {float(tm['grad_norm']):.5f}", flush=True)
    print(f"worst relative loss gap {worst:.3g} (bar {RTOL})")
    return 0 if worst <= RTOL else 1


if __name__ == "__main__":
    sys.exit(main())
