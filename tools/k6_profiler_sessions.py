#!/usr/bin/env python3
"""How often a torch.profiler session around one K6 call records no K6
kernel, on one NVIDIA GPU.

    PYTHONPATH=src python3 tools/k6_profiler_sessions.py [--sessions 120] [--fresh 0]

Repeats the route check of ``chip_smoke.py`` phase 3 at smollm-360m's
shape (8 x 15 heads x 2048 x 64 over 5 KV heads, bf16, causal): the plain
version, its comparison with the kernel, a bf16 -> float32 copy left
queued, then one profiler session (CUDA activity) around K6 calls.
Three variants, interleaved: ``queued`` opens the session with that copy
still on the stream and makes one call, ``synced`` calls
torch.cuda.synchronize() first, ``synced3`` also makes three calls.
Each runs ``--sessions`` times in one process, and ``--fresh`` times as
the first session of a new process.  Prints, per variant, how many
sessions saw no K6 kernel and what each saw instead, how many sessions
saw CUPTI ask for an activity buffer ("Activity Buffer Request"), and
how many K6 launches the session after an empty one recorded (more than
it made means the lost records arrived late), and when each empty
session opened.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

VARIANTS = ("queued", "synced", "synced3")


def session(torch, fa, q, k, v, variant: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    want = fa.flash_attention_plain(q, k, v, causal=True)
    float((fa.flash_attention(q, k, v, causal=True).float()
           - want.float()).abs().max())
    want.float()                         # left on the stream, as in phase 3
    if variant != "queued":
        torch.cuda.synchronize()
    calls = 3 if variant == "synced3" else 1
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
    events = prof.key_averages()
    seen = sorted({e.key for e in events})
    k6 = sum(e.count for e in events
             if "flash_mma_kernel" in e.key or "flash_kernel" in e.key)
    return {"variant": variant, "calls": calls, "k6": k6, "seen": seen[:6],
            "buffer_request": "Activity Buffer Request" in seen, "t": t}


def inputs(torch):
    gen = torch.Generator().manual_seed(0)
    draw = lambda *s: torch.randn(*s, generator=gen).to(  # noqa: E731
        "cuda", torch.bfloat16)
    return draw(8, 15, 2048, 64), draw(8, 5, 2048, 64), draw(8, 5, 2048, 64)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=120)
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--first", choices=VARIANTS, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    q, k, v = inputs(torch)
    if args.first:
        print(json.dumps(session(torch, fa, q, k, v, args.first)))
        return 0

    results = [session(torch, fa, q, k, v, variant)
               for _ in range(args.sessions) for variant in VARIANTS]
    env = dict(os.environ)
    for _ in range(args.fresh):
        for variant in VARIANTS:
            out = subprocess.run([sys.executable, __file__, "--first",
                                  variant], env=env, check=True, timeout=300,
                                 capture_output=True, text=True).stdout
            results.append(dict(json.loads(out.splitlines()[-1]),
                                fresh=True))
    for variant in VARIANTS:
        for fresh in (False, True):
            rows = [r for r in results
                    if r["variant"] == variant and r.get("fresh", False)
                    == fresh]
            if not rows:
                continue
            empty = [r for r in rows if r["k6"] == 0]
            where = "first session of a new process" if fresh \
                else "one process"
            asked = [r for r in rows if r["buffer_request"]]
            print(f"{variant}, {where}: {len(empty)} of {len(rows)} "
                  f"sessions saw no K6 kernel; {len(asked)} saw a buffer "
                  f"request, {sum(r['k6'] == 0 for r in asked)} of them "
                  f"empty")
            for r in empty:
                print(f"  saw instead: {r['seen']}")
    inline = results[:len(VARIANTS) * args.sessions]
    for i, r in enumerate(inline[:-1]):
        if r["k6"] == 0:
            after = inline[i + 1]
            print(f"after an empty {r['variant']} session, the next "
                  f"({after['variant']}, {after['calls']} calls) recorded "
                  f"{after['k6']} K6 launches")
    t0 = inline[0]["t"]
    gaps = [r["t"] - t0 for r in inline if r["k6"] == 0]
    print(f"sessions: {len(inline)} in {inline[-1]['t'] - t0:.3f} s; the "
          f"empty ones opened at (s): {[round(g, 3) for g in gaps]}")
    short = [r for r in inline if 0 < r["k6"] != r["calls"]]
    print(f"sessions that recorded some K6 launches but not as many as "
          f"they made: {len(short)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
