"""Serving driver, LM lane (counterpart of ``repro.launch.serve``'s
``serve_lm`` and ``main``).

``python -m repro_torch.launch.serve --arch minicpm-2b`` prefills waves of
prompts and decodes tokens with the KV cache, on the card by default
(``--device cpu`` runs the plain path).  Requests are served in waves of
``batch_slots``: the slots of a wave share one cache length, each wave
prefills by one-token decode steps over its prompts and then decodes
``gen_len - 1`` more tokens, exactly as the reference's loop does.  The
DIN and nucleus lanes (``--arch din``, ``--arch nucleus``) are not yet
ported and raise.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import get_arch
from ..device import DeviceLike, resolve_device
from ..models import transformer as T
from . import steps as S

NOT_PORTED = ("din", "nucleus")


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
                                  f"repro_torch; this slice serves the "
                                  f"dense LM archs")
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain path)")
    args = ap.parse_args()
    serve_lm(args.arch, n_requests=args.requests, device=args.device)


if __name__ == "__main__":
    main()
