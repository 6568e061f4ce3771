"""Batched LM serving with a KV cache (continuous-wave batching).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
        --arch deepseek-v2-lite-16b [--device cpu]

Uses the reduced (smoke) config; the decode step is the same function
``launch.dryrun`` runs for decode_32k on the production meshes (MLA archs
decode from the compressed-latent cache).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from ..launch.serve import serve_lm


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain path; default: the card")
    args = ap.parse_args(argv)
    outs = serve_lm(args.arch, n_requests=args.requests, batch_slots=4,
                    prompt_len=8, gen_len=args.gen_len, smoke=True,
                    device=args.device)
    first = outs[0][:10].tolist()
    print(f"first request tokens: {first}")
    return {"tokens": outs, "first": first}


if __name__ == "__main__":
    main()
