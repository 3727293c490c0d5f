#!/usr/bin/env python3
"""K1 (upload_fused) and K2 (window_fold) alone on one NVIDIA GPU: what
bounds each, and how the kernels of two source trees compare.

    python3 tools/upload_fold_probe.py [--src DIR] [--label NAME]

Imports `repro_torch` from DIR (default: this checkout's ``src``; give
another checkout's, such as an earlier commit unpacked with `git archive`
into a git-ignored directory, to time its kernels in the same call),
builds K1 and K2 from that tree's ``csrc`` with ``-Xptxas -v``, prints
each kernel instantiation's registers and SASS instruction count
(`cuobjdump -sass`), then holds and times, as ``chip_smoke.py`` phase 3
does (CUDA events, L2 flushed, median of 30 calls), K1 at (1000, 20490)
on the paper CNN's leaves with flags 15 (sigma 0.05) and 11 (noise off)
and at (4, 300001) sigma 0.7, and K2 at (256, 20490), each beside a
`Tensor.copy_` of the same bytes; then K2 and that copy again with an L2
flush that leaves clean lines, to show what the dirty lines of the usual
flush cost at K2's 42 MB.  Ends with one JSON line of the readings.  Compare two trees in one call, in turns:
earlier, this, this, earlier.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("upload_fold_probe: no CUDA device", file=sys.stderr)
        return 2
    # The tree under test first: chip_smoke's own path entry comes after.
    from repro_torch.kernels import _build
    from repro_torch.kernels import window_fold as wf
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    print(f"{args.label}: repro_torch from {os.path.dirname(wf.__file__)}; "
          f"{cs.card_line()}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("upload_fused", "window_fold"):
        lib = _build.library_path(name)
        if lib.exists():
            lib.unlink()                    # rebuild to see ptxas's report
    _, logs = _build.timed_build(("upload_fused", "window_fold"),
                                 ("-Xptxas", "-v"))
    for name, log in logs.items():
        sass = cs.sass_counts(_build.library_path(name))
        for fn, regs in sorted(cs.ptxas_rows(log).items()):
            print(f"  {name} {fn}: {regs}; SASS {sass[fn][0]} instructions")

    gen = torch.Generator().manual_seed(0)
    n_cnn = sum(cs.CNN_LEAVES)
    readings = {
        "k1_flags15": cs.check_upload_fused(torch, gen, 1000, cs.CNN_LEAVES,
                                            0.05, 15, plain=False),
        "k1_flags11": cs.check_upload_fused(torch, gen, 1000, cs.CNN_LEAVES,
                                            0.05, 11, plain=False),
        "k1_big": cs.check_upload_fused(torch, gen, 4,
                                        (100000, 170000, 30001), 0.7, 15,
                                        plain=False),
        "k2": cs.check_window_fold(torch, gen, 256, n_cnn, plain=False)}
    for key, res in readings.items():
        tol = "2e-06" if key in ("k1_flags15", "k1_big") else "0 (bitwise)"
        print(f"  {key}: " + cs.upload_fold_reading(tol, res))
    fold = cs.window_fold_inputs(torch, gen, 256, n_cnn)
    src = torch.ones(256 * n_cnn, device="cuda")
    dst = torch.empty_like(src)
    for clean in (False, True):
        k2 = cs.time_ms(lambda: wf.window_fold_fleet(*fold), clean_l2=clean)
        yard = cs.time_ms(lambda: dst.copy_(src), clean_l2=clean)
        readings[f"k2 clean_l2={clean}"] = (k2, yard)
        print(f"  k2 at (256, {n_cnn}), L2 flushed "
              f"{'clean' if clean else 'dirty'}: kernel {k2!r} ms, copy_ "
              f"of the same bytes {yard!r} ms")
    print(json.dumps({"label": args.label, "card": cs.card_line(),
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
