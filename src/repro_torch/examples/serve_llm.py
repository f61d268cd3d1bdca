"""Batched LLM serving demo: prefill + token-by-token decode with a KV
cache (gemma2 reduced: alternating local/global attention, softcaps) and a
recurrent-state architecture (xlstm reduced) side by side.

The port's twin of ``examples/serve_llm.py``. The reduced configs run in
f32 at head_dim 32: on the card gemma2's prefill attention runs through
the f32 flash kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_llm [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import serve

ARCHS = ("gemma2-9b", "xlstm-350m")


def main(argv=None, params=None) -> dict:
    """Serve each of ``ARCHS``; ``params`` ({arch: model}) replaces the
    weights drawn from the seed. Returns ``{arch: serve()'s dict}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    args = ap.parse_args(argv)
    outs = {}
    for arch in ARCHS:
        out = serve(arch, reduced=True, n_requests=args.requests,
                    prompt_len=args.prompt_len, gen_len=args.gen,
                    params=(params or {}).get(arch), device=args.device)
        print(f"{arch}: prefill {out['prefill_s']:.2f}s, "
              f"{out['decode_s_per_token'] * 1e3:.0f} ms/token, "
              f"first request tokens: {out['generated'][0].tolist()}")
        outs[arch] = out
    return outs


if __name__ == "__main__":
    main()
