"""LLM serving on PyTorch: batched prefill, then greedy decode.

Port of ``repro.launch.serve``: requests are padded to one prompt length,
prefilled once (attention through the flash-attention kernel on the card),
then decoded token by token against the shared KV cache, padded to the
full length in bf16 as ``repro.launch.serve`` pads it. Prompts come from
``np.random.default_rng(seed)`` exactly as there. A vision frontend
(pixtral) gets zero patch embeddings, (B, n_frontend_tokens, d) in f32,
before the prompt, and the cache and decode positions are offset by them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
      --reduced --requests 2 --prompt-len 24 --gen 8 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import registry


def pad_cache_to(cache, target):
    """Copy each prefill cache tensor into the front of its zero target,
    cast to the target's dtype (``repro.launch.serve``'s pad, then
    ``astype``). Fills ``target`` in place and returns it."""
    for name, t in target.items():
        c = cache[name]
        if c.dim() != t.dim() or any(a > b for a, b in zip(c.shape, t.shape)):
            raise ValueError(f"cache {name}: {tuple(c.shape)} does not fit "
                             f"in {tuple(t.shape)}")
        t[tuple(slice(0, n) for n in c.shape)] = c
    return target


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, reduced: bool, n_requests: int, prompt_len: int,
          gen_len: int, greedy: bool = True, seed: int = 0, *, params=None,
          device=None):
    """Prefill ``n_requests`` random prompts of ``prompt_len`` tokens, then
    decode ``gen_len - 1`` more tokens greedily. ``params`` (a
    ``Transformer`` on ``device``) defaults to random weights drawn on the
    device from ``seed``. Returns ``repro.launch.serve.serve``'s dict:
    ``generated`` (n_requests, gen_len) int, ``prefill_s``,
    ``decode_s_per_token``, ``tokens_per_s``."""
    if not greedy:
        raise NotImplementedError(
            "only greedy decoding, as repro.launch.serve")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    dev = resolve(device)
    api = registry.get_model(cfg)
    if params is None:
        params = api.init(seed, device=dev)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(n_requests, prompt_len)).astype(np.int32)
    max_len = prompt_len + gen_len

    batch = {"tokens": torch.from_numpy(prompts).to(dev)}
    n_prefix = 0
    if cfg.frontend == "vision":
        n_prefix = cfg.n_frontend_tokens
        batch["prefix_embeds"] = torch.zeros(
            (n_requests, n_prefix, cfg.d_model), dtype=torch.float32,
            device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, batch)
    cache = pad_cache_to(cache, api.empty_cache(n_requests,
                                                n_prefix + max_len,
                                                device=dev))
    out_tokens = [logits[:, -1].argmax(-1)]
    del logits
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for step in range(gen_len - 1):
        logits, cache = api.decode(params, cache,
                                   {"tokens": out_tokens[-1][:, None]},
                                   n_prefix + prompt_len + step)
        out_tokens.append(logits[:, -1].argmax(-1))
    gen = torch.stack(out_tokens, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t0
    return {
        "generated": gen,
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(gen_len - 1, 1),
        "tokens_per_s": n_requests * (gen_len - 1) / max(t_decode, 1e-9),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = serve(args.arch, args.reduced, args.requests, args.prompt_len,
                args.gen, device=args.device)
    print("generated tokens:\n", out["generated"])
    print(f"prefill {out['prefill_s']:.2f}s, "
          f"{out['decode_s_per_token'] * 1e3:.1f} ms/token, "
          f"{out['tokens_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
