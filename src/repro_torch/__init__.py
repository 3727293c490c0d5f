"""PyTorch / CUDA port of the `repro` federated edge learning framework.

The JAX package `repro` is the reference; this package runs the same
framework (ALDPFL and its synchronous sibling, through the same
`api.run(api.compile_plan(spec))` entry point) on one NVIDIA GPU, with
hand-written CUDA kernels in place of the Pallas kernels on that path
(`kernels.upload_fused`, `kernels.window_fold`).  It imports torch, numpy
and the standard library only — never `jax` and never `repro`.

Entry points run on ``device="cuda"`` by default and raise when no card
is present unless the caller asks for ``device="cpu"``.
"""
