"""Batched serving driver: prefill a batch of prompts, then decode greedily.

Port of `repro.launch.serve`, with the same flags plus ``--device``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --full --batch 8 --prompt-len 512 --gen 33

``--arch`` takes every config of the zoo: the dense family
(smollm-360m, qwen1.5-0.5b, olmo-1b, codeqwen1.5-7b), the moe family
(kimi-k2-1t-a32b, llama4-scout-17b-a16e), the ssm family
(falcon-mamba-7b), the hybrid family (zamba2-1.2b), the vlm family
(qwen2-vl-72b: each prompt follows ``n_patches`` patch embeddings) and
the audio family (whisper-large-v3: the decoder cross-attends to
``n_audio_frames`` frame embeddings).  It runs on the card unless
``--device cpu`` is given.  Params are drawn from a `torch.Generator`
seeded 0; the prompts, then the vlm patches or audio frames, from one
``np.random.default_rng(0)`` as the reference draws them; the cache
(KV, cross and SSM states) is float32, as the reference's
`launch.serve` makes it, and the vlm family's holds the patches too.  Prefill and decode are
timed on the host clock, each ended by a device synchronise.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..device import resolve
from ..models import decode_step, init_cache, init_params, prefill


def make_token_batches(tokens: np.ndarray, lead_shape, seq: int, rng,
                       device="cpu") -> Dict[str, torch.Tensor]:
    """Sample token windows of ``make_token_dataset`` output into the
    requested leading shape: tokens and their next-token targets (the
    dense-family counterpart of the reference's `launch.train.make_batches`,
    with the same draws)."""
    n_seq = int(np.prod(lead_shape))
    idx = rng.integers(0, tokens.shape[0], n_seq)
    toks = tokens[idx, :seq].reshape(tuple(lead_shape) + (seq,))
    tgts = tokens[idx, 1:seq + 1].reshape(tuple(lead_shape) + (seq,))
    return {"tokens": torch.as_tensor(toks, device=device),
            "targets": torch.as_tensor(tgts, device=device)}


def prompts(vocab: int, batch: int, prompt_len: int, seed: int = 0,
            device="cpu") -> torch.Tensor:
    """The reference driver's prompts: (batch, prompt_len) int32."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.integers(0, vocab, (batch, prompt_len)).astype(np.int32),
        device=device)


def request_batch(cfg, batch: int, prompt_len: int, seed: int = 0,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """The reference `launch.serve`'s requests, drawn in its order from one
    ``default_rng(seed)``: tokens (batch, prompt_len) int32 (as
    `prompts`), then for the vlm family patches (batch, n_patches,
    d_model) and for the audio family frames (batch, n_audio_frames,
    d_model), standard normal float64 draws cast to float32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32),
        device=device)}
    extra = {"vlm": ("patches", cfg.n_patches),
             "audio": ("frames", cfg.n_audio_frames)}.get(cfg.family)
    if extra is not None:
        name, n = extra
        out[name] = torch.as_tensor(
            rng.normal(0, 1, (batch, n, cfg.d_model)).astype(np.float32),
            device=device)
    return out


def cache_length(cfg, prompt_len: int, gen: int) -> int:
    """Cache slots a request needs: the prompt, the generated tokens and,
    for the vlm family, the patches ahead of the prompt."""
    return prompt_len + gen + (cfg.n_patches if cfg.family == "vlm" else 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def serve(params: dict, cfg, tokens: torch.Tensor, gen: int,
          **extras: torch.Tensor) -> dict:
    """Prefill ``tokens`` (B, S), after the vlm family's ``patches`` or
    over the audio family's ``frames`` (``extras``, as `request_batch`
    draws them), then ``gen - 1`` greedy decode steps over a float32
    cache (KV slots, cross keys and values, SSM states), as the
    reference's `launch.serve` makes it.
    Returns the generated ids (B, gen) and the prefill and decode wall
    seconds (host clock, each ended by a synchronise)."""
    dev = tokens.device
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_length(cfg, S, gen),
                       dtype=torch.float32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, dict(extras, tokens=tokens), cache)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "prefill_s": t_prefill,
            "decode_s": t_decode, "last_logits": logits}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(attn_chunk=min(cfg.attn_chunk, args.prompt_len))
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    B = args.batch
    batch = request_batch(cfg, B, args.prompt_len, device=dev)
    res = serve(params, cfg, batch.pop("tokens"), args.gen, **batch)
    t_pre, dt = res["prefill_s"], res["decode_s"]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen} device={name}")
    print(f"prefill: {t_pre:.3f}s ({B * args.prompt_len / t_pre:.0f} tok/s)")
    print(f"decode: {dt:.3f}s ({B * (args.gen - 1) / max(dt, 1e-9):.0f} "
          f"tok/s)")
    print("sample generations (token ids):")
    for row in res["tokens"].cpu().numpy()[:2]:
        print("  ", row[:16].tolist())


if __name__ == "__main__":
    main()
