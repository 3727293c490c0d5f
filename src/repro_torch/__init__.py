"""PyTorch / CUDA port of the `repro` federated edge learning framework.

The JAX package `repro` is the reference; this package runs the same
framework (ALDPFL and its synchronous sibling, through the same
`api.run(api.compile_plan(spec))` entry point, with the network layer,
the observability layer `obs` and the simulation service `sim` with its
checkpoints) and the model zoo's dense, ssm and hybrid families (`models`,
`launch.serve`) on one NVIDIA GPU, with hand-written CUDA kernels
(`kernels/`, sources in `csrc/`) in place of every Pallas kernel of the
reference.  It imports
torch, numpy and the standard library only (and `ml_dtypes` when
`convert.to_numpy` hands bfloat16 to numpy) — never `jax` and never
`repro`.

Entry points run on ``device="cuda"`` by default and raise when no card
is present unless the caller asks for ``device="cpu"``.
"""
