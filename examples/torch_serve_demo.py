"""Batched serving on the PyTorch port: prefill + KV-cache decode across
architecture families (dense GQA ring-cache, Mamba O(1) state, hybrid
both, MoE, encoder-decoder), with a mid-generation checkpoint (the twin of
`examples/serve_demo.py`): the decode state (cache + last token) is saved
through `repro_torch.checkpointing` halfway, reloaded, and the tail
regenerated to show the resumed continuation emits identical tokens.

  PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.checkpointing import (load_checkpoint,  # noqa: E402
                                       save_checkpoint)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.launch.serve import (_sync, cache_length,  # noqa: E402
                                      request_batch)
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                init_params, prefill)

ARCHS = ("smollm-360m", "falcon-mamba-7b", "zamba2-1.2b", "kimi-k2-1t-a32b",
         "whisper-large-v3")


@torch.no_grad()
def serve(arch: str, dev, batch=2, prompt=16, gen=8) -> None:
    cfg = get_smoke_config(arch).replace(attn_chunk=prompt)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    b = request_batch(cfg, batch, prompt, device=dev)
    cache = init_cache(cfg, batch, cache_length(cfg, prompt, gen),
                       dtype=torch.float32, device=dev)
    logits, cache = prefill(params, cfg, b, cache)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)

    def decode(tok, cache, steps):
        toks = []
        for _ in range(steps):
            logits, cache = decode_step(params, cfg, tok, cache)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            toks.append(tok)
        return toks, tok, cache

    def clone(t):
        return {k: clone(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.clone()

    half = (gen - 1) // 2
    _sync(dev)
    t0 = time.time()
    head, mid_tok, mid_cache = decode(tok, cache, half)
    # snapshot the decode state mid-generation: KV/SSM cache + last token
    # (decode writes the cache in place, so the snapshot keeps a copy)
    snap = {"cache": clone(mid_cache), "tok": mid_tok.clone()}
    with tempfile.TemporaryDirectory(prefix="serve_") as tmp:
        ckpt = os.path.join(tmp, arch)
        save_checkpoint(ckpt, snap, step=half)
        tail, _, _ = decode(mid_tok, mid_cache, gen - 1 - half)
        _sync(dev)
        dt = time.time() - t0
        out = torch.cat([tok] + head + tail, 1)
        # resume: reload the snapshot and regenerate the tail
        loaded, _ = load_checkpoint(ckpt, snap)
    tail2, _, _ = decode(loaded["tok"], loaded["cache"], gen - 1 - half)
    resumed = torch.cat([tok] + head + tail2, 1)
    if not torch.equal(out, resumed):
        raise SystemExit(f"{arch}: resumed decode diverged")
    print(f"{arch:22s} [{cfg.family:6s}] decode {batch}x{gen - 1} tokens "
          f"in {dt:5.2f}s -> {out[0, :8].cpu().tolist()} "
          f"(resume parity ok)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--gen", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    for arch in args.archs.split(","):
        serve(arch, dev, gen=args.gen)


if __name__ == "__main__":
    main()
