#!/usr/bin/env python3
"""K1 (upload_fused), K2 (window_fold), K3 (wire_bytes), K5 (ldp_noise),
K7 (ssd_scan) and K8 (selective_scan) alone on one NVIDIA GPU: what bounds
each, and how the kernels of two source trees compare.

    python3 tools/upload_fold_probe.py [--src DIR] [--label NAME]
                                       [--kernels k1,k2,k3,k5,k7,k8]

Imports `repro_torch` from DIR (default: this checkout's ``src``; give
another checkout's, such as an earlier commit unpacked with `git archive`
into a git-ignored directory, to time its kernels in the same call),
builds the picked kernels from that tree's ``csrc`` with ``-Xptxas -v``,
prints each kernel instantiation's registers and SASS instruction count
(`cuobjdump -sass`; K7's HMMA instructions, K8's on one step's path of its
scan), then holds and times, as ``chip_smoke.py`` phase 3
does (CUDA events, L2 flushed, median of 30 calls), K1 at (1000, 20490)
on the paper CNN's leaves with flags 15 (sigma 0.05) and 11 (noise off)
and at (4, 300001) sigma 0.7, and K2 at (256, 20490), each beside a
`Tensor.copy_` of the same bytes; then K2 and that copy again with an L2
flush that leaves clean lines, to show what the dirty lines of the usual
flush cost at K2's 42 MB.  ``--kernels`` picks among them (default
``k1,k2``, the readings above): ``k3`` holds and times K3 at (1000, 20490)
on rows of mixed sparsity beside `torch.count_nonzero` and a read of the
same bytes (`sum(dim=1)`), then K3 and that read with the clean flush;
``k5`` holds and times K5 at (1000, 20490) with sigma 0.05 and with
sigma*S = 0 and at (4, 300001) sigma 0.7, each bitwise against K1 with
flags 6 or 2 on the same inputs (timed beside it) and beside a `copy_` of
the same bytes, and reads the SM clock under K5 for the issue estimate of
each K5 instantiation (the instructions on a run's path,
`chip_smoke.run_path_instructions`).  ``k8`` holds and times K8 at
falcon-mamba-7b's (4, 2048, 8192), N 16, bf16 and a ragged float32
(3, 1000, 1000), reads the SM clock under K8 and prints its operation
bound (`chip_smoke.k8_ops_ms`) beside its byte bound and its issue
estimate from its own SASS (`chip_smoke.k8_issue`); ``k7`` holds and
times K7 at zamba2-1.2b's (8, 2048, 64, 64), N 64, chunk 128, bf16 and a
ragged float32 (2, 1000, 7, 64).  Ends with one JSON line of the
readings.  Compare two trees in one call, in turns: earlier, this, this,
earlier.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The libraries each pick builds (K5 is held against K1).
LIBS = {"k1": ("upload_fused",), "k2": ("window_fold",),
        "k3": ("wire_bytes",), "k5": ("ldp_noise", "upload_fused"),
        "k7": ("ssd_scan",), "k8": ("selective_scan",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--kernels", default="k1,k2",
                    help="comma-separated subset of k1, k2, k3, k5, k7, k8")
    args = ap.parse_args()
    picked = set(args.kernels.split(","))
    unknown = picked - set(LIBS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
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
    names = sorted({lib for k in picked for lib in LIBS[k]})
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        lib = _build.library_path(name)
        if lib.exists():
            lib.unlink()                    # rebuild to see ptxas's report
    _, logs = _build.timed_build(names, ("-Xptxas", "-v"))
    sass = {}
    for name, log in logs.items():
        sass[name] = cs.sass_listing(_build.library_path(name))
        for fn, regs in sorted(cs.ptxas_rows(log).items()):
            ins = sass[name][fn]
            if name in ("ssd_scan", "selective_scan"):
                note = cs.sass_note(name, fn, ins)
            else:
                run = cs.run_path_instructions(ins)
                note = f", {run} on a run's path" if run is not None else ""
            print(f"  {name} {fn}: {regs}; SASS {len(ins)} instructions"
                  + note)

    gen = torch.Generator().manual_seed(0)
    n_cnn = sum(cs.CNN_LEAVES)
    readings = {}
    if "k1" in picked:
        for key, flags, c, sizes, sigma in (
                ("k1_flags15", 15, 1000, cs.CNN_LEAVES, 0.05),
                ("k1_flags11", 11, 1000, cs.CNN_LEAVES, 0.05),
                ("k1_big", 15, 4, (100000, 170000, 30001), 0.7)):
            readings[key] = cs.check_upload_fused(torch, gen, c, sizes, sigma,
                                                  flags, plain=False)
            tol = "2e-06" if flags & 4 else "0 (bitwise)"
            print(f"  {key}: " + cs.upload_fold_reading(tol, readings[key]))
    if "k2" in picked:
        readings["k2"] = cs.check_window_fold(torch, gen, 256, n_cnn,
                                              plain=False)
        print("  k2: " + cs.upload_fold_reading("0 (bitwise)",
                                                readings["k2"]))
        fold = cs.window_fold_inputs(torch, gen, 256, n_cnn)
        src = torch.ones(256 * n_cnn, device="cuda")
        dst = torch.empty_like(src)
        for clean in (False, True):
            k2 = cs.time_ms(lambda: wf.window_fold_fleet(*fold),
                            clean_l2=clean)
            yard = cs.time_ms(lambda: dst.copy_(src), clean_l2=clean)
            readings[f"k2 clean_l2={clean}"] = (k2, yard)
            print(f"  k2 at (256, {n_cnn}), L2 flushed "
                  f"{'clean' if clean else 'dirty'}: kernel {k2!r} ms, copy_ "
                  f"of the same bytes {yard!r} ms")
    if "k3" in picked:
        from repro_torch.kernels import wire_bytes as wb
        readings["k3"] = cs.check_nnz(torch, gen, 1000, n_cnn, plain=False)
        print("  k3 at (1000, 20490): " + cs.nnz_reading(readings["k3"]))
        x = cs.mixed_rows(torch, gen, 1000, n_cnn)
        k3 = cs.time_ms(lambda: wb.nnz_fleet(x), clean_l2=True)
        read = cs.time_ms(lambda: x.sum(dim=1), clean_l2=True)
        readings["k3 clean_l2=True"] = (k3, read)
        print(f"  k3 at (1000, {n_cnn}), L2 flushed clean: kernel {k3!r} ms, "
              f"sum(dim=1) of the same bytes {read!r} ms")
    if "k5" in picked:
        from repro_torch.kernels import ldp_noise as ldp
        for key, c, n, sigma in (("k5", 1000, n_cnn, 0.05),
                                 ("k5_quiet", 1000, n_cnn, 0.0),
                                 ("k5_big", 4, 300001, 0.7)):
            readings[key] = cs.check_ldp(torch, gen, c, n, sigma,
                                         plain=False)
            print(f"  {key} at ({c}, {n}) sigma {sigma}: "
                  + cs.ldp_reading(sigma, readings[key]))
        k5_args = cs.ldp_inputs(torch, gen, 1000, n_cnn, 0.05)
        clock = readings["sm_clock_mhz"] = cs.sm_clock_mhz(
            torch, lambda: ldp.ldp_perturb_fleet(*k5_args))
        print(f"  SM clock under K5: {clock!r} MHz")
        for fn, ins in sorted(sass["ldp_noise"].items()):
            run, per = cs.run_path_instructions(ins), 8 if "ILb1E" in fn else 4
            if run is None:                 # no 16-byte runs to walk
                continue
            est = cs.issue_ms(run / per, 1000 * n_cnn, clock)
            readings[f"k5 issue {fn}"] = est
            print(f"  {fn}: {run} instructions on a run's path of {per} "
                  f"elements: issue estimate at (1000, {n_cnn}) {est!r} ms")
    gen_card = torch.Generator("cuda").manual_seed(0)
    if "k8" in picked:
        from repro_torch.kernels import selective_scan as ss
        for key, shape, dtype in (("k8", (4, 2048, 8192, 16), torch.bfloat16),
                                  ("k8_ragged", (3, 1000, 1000, 16),
                                   torch.float32)):
            err, ms, _, bound, by, k8_args = cs.check_selective_scan(
                torch, gen_card, *shape, dtype, plain=False)
            readings[key] = (err, ms, bound, by)
            print(f"  {key} at {shape[:3]}, N {shape[3]}, {dtype}: max |err| "
                  f"{err!r}; kernel {ms!r} ms, byte bound {bound!r} ms")
            if key == "k8":
                main_args = k8_args
        clock = cs.sm_clock_mhz(torch, lambda: ss.selective_scan(*main_args))
        ops = cs.k8_ops_ms(4, 2048, 8192, 16, clock)
        issue = cs.k8_issue(sass["selective_scan"], 4, 2048, 8192, 16, clock)
        readings["k8_bounds"] = (clock, ops, issue)
        print(f"  k8 at (4, 2048, 8192), N 16, bf16: SM clock under K8 "
              f"{clock!r} MHz; operation bound {ops!r} ms "
              f"({cs.K8_STATE_STEP_INSTRUCTIONS} instructions a state-step); "
              + ("no bf16 kernel for N 16 in this tree's library: no issue "
                 "estimate" if issue is None else
                 f"issue estimate from its SASS {issue[2]!r} ms ({issue[0]!r} "
                 f"instructions on one step's path of {issue[1]} states)"))
        del main_args
    if "k7" in picked:
        for key, shape, dtype in (("k7", (8, 2048, 64, 64, 64, 128),
                                   torch.bfloat16),
                                  ("k7_ragged", (2, 1000, 7, 64, 64, 128),
                                   torch.float32)):
            err, ms, _, bound, by, f32, _ = cs.check_ssd_scan(
                torch, gen_card, *shape, dtype, plain=False, route=False)
            readings[key] = (err, ms, bound, by)
            print(f"  {key} at {shape[:4]}, N {shape[4]}, chunk {shape[5]}, "
                  f"{dtype}: max |err| {err!r}; kernel {ms!r} ms, bound "
                  f"{bound!r} ms ({by}), at the float32 rate {f32!r} ms")
    print(json.dumps({"label": args.label, "card": cs.card_line(),
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
