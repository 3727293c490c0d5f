"""The sharded LLM steps in a gloo world of 4 ranks on a (data 2, model 2)
mesh, against the reference and the unsharded port on the same inputs.

The params are the reference's init (`repro.models.init_params`, carried
across with `convert.to_torch`) and every batch is drawn with numpy from
a seed.  One spawn of 4 processes (joined through a ``file://`` store
under the test's own directory) runs every case; the parent meanwhile
computes the same steps with the unsharded port and with the reference
(`repro.launch.steps.make_step` jitted, as `tests/test_torch_train.py`
runs it; the forward `repro.models.forward` jitted, its flash kernel in
interpret mode).  Cases:

* the scoring forward (logits and aux loss), ``plain_train`` (SGD on the
  grads pinned to the params' placements), ``prefill`` and ``decode``
  (the KV or SSM cache placed by `cache_pspecs`) for the dense, moe, ssm,
  hybrid, vlm and audio smoke configs; smollm-360m's smoke config has 3 heads
  of 80 and one KV head, so the model axis cuts its heads and DTensor
  must gather them before the (B, S, H, hd) view; its forward also runs
  with ``use_flash`` (K6's route on each rank's local block), and its SFL
  step with ``seq_parallel`` (the stream's sequence on "model" between
  blocks);
* ``fed_train`` (4 nodes, two per data rank): Alg. 2's accuracies, its
  threshold and the count it keeps equal (2 of 4), the new params close;
* the noise of `aldp.add_gaussian_noise` on params placed over both mesh
  axes: bit for bit the unsharded draw and the reference's;
* the Mamba mixers tensor parallel on "model" (`models.ssm.mixer_tp`):
  a spy on the chunked scans and the decode steps reads each rank's
  block (the smoke configs' d_inner 512 and 16 heads over 2 model
  ranks), once a layer, and prefill and decode hand their SSM states
  back in `cache_pspecs`' placements.

Limits (float32):

* sharded against unsharded port: the sharded step sums some products
  across ranks (a row-parallel product's partial sums, the norms' and
  the masked mean's sums over shards), in another order than one device
  does, so values agree to rounding: logits, caches and losses within
  1e-5, params within 1e-6 (the largest difference read 3.8e-6, a
  cache, when this was written);
* unsharded port against the reference: the port's limits against JAX
  (`tests/test_torch_llm.py`: whole-model logits and caches within 1e-4;
  `tests/test_torch_train.py`: params after a step within 1e-6), XLA and
  PyTorch summing in other orders (the largest difference read 9.7e-6,
  the hybrid's prefill logits);
* sharded port against the reference: the sum of the two.

The MoE routing of the sharded run is pinned to the unsharded run's
choices (as the card's checks pin it), so a rounding-level tie cannot
reroute a token; the count of tokens whose own choice differed is kept
too.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import aldp as jaldp
from repro.core.fed_step import FedStepConfig as JFed
from repro.launch import steps as jsteps
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro_torch import convert, tree
from repro_torch.configs import get_smoke_config
from repro_torch.core.fed_step import FedStepConfig
from repro_torch.launch import steps
from repro_torch.models import forward, init_cache, moe, prefill

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
RANK_TIMEOUT_S = 600
ARCHS = {"dense": "smollm-360m", "moe": "kimi-k2-1t-a32b",
         "ssm": "falcon-mamba-7b", "hybrid": "zamba2-1.2b",
         "vlm": "qwen2-vl-72b", "audio": "whisper-large-v3"}
KINDS = ("forward", "plain_train", "prefill", "decode")
B, S, CACHE = 4, 16, 32
LOGIT_TOL, PARAM_TOL = 1e-5, 1e-6            # sharded against unsharded
REF_LOGIT_TOL, REF_PARAM_TOL = 1e-4, 1e-6    # the port against the reference
FKW = dict(n_nodes=4, local_steps=1, lr=1e-2, alpha=0.5, clip_s=1.0,
           sigma=1e-3, detect=True, detect_s=50.0)
FCFG = FedStepConfig(**FKW)
FED_KEY, NOISE_KEY = np.array([5, 6], np.uint32), np.array([7, 8], np.uint32)


def _cfg(arch, variant=""):
    """A smoke config; "flash": with use_flash, "seq": with
    seq_parallel."""
    cfg = get_smoke_config(arch)
    if variant == "flash":
        return cfg.replace(use_flash=True)
    if variant == "seq":
        return cfg.replace(seq_parallel=True)
    return cfg


def _jcfg(arch, variant=""):
    """The reference's smoke config, as `_cfg` varies the port's."""
    cfg = jconfigs.get_smoke_config(arch)
    if variant == "flash":
        return cfg.replace(use_flash=True)
    if variant == "seq":
        return cfg.replace(seq_parallel=True)
    return cfg


def _params(arch, seed):
    """The reference's init of ``arch``'s smoke config, as the port's."""
    return convert.to_torch(j_init(_jcfg(arch), jax.random.PRNGKey(seed)))


def _batch(cfg, rng, lead=(), b=B, s=S, targets=True):
    """A batch drawn with numpy, as tensors."""
    out = {"tokens": rng.integers(0, cfg.vocab, lead + (b, s),
                                  dtype=np.int32)}
    if targets:
        out["targets"] = rng.integers(0, cfg.vocab, lead + (b, s),
                                      dtype=np.int32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            lead + (b, cfg.n_audio_frames, cfg.d_model), dtype=np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            lead + (b, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _clone(t):
    if isinstance(t, dict):
        return tree.map(lambda x: x.clone(), t)
    return t.clone() if isinstance(t, torch.Tensor) else t


def _inputs():
    """{case: (arch, kind, variant, args)}, every input from one seed."""
    cases = {}
    for fam, arch in ARCHS.items():
        cfg = _cfg(arch)
        params = _params(arch, len(cases))
        rng = np.random.default_rng(len(cases))
        cases[(fam, "forward")] = (arch, "forward", "",
                                   (params, _batch(cfg, rng)))
        cases[(fam, "plain_train")] = (arch, "plain_train", "",
                                       (params, _batch(cfg, rng)))
        prompt = _batch(cfg, rng, targets=False)
        cases[(fam, "prefill")] = (
            arch, "prefill", "",
            (params, prompt, init_cache(cfg, B, CACHE, torch.float32)))
        _, cache = prefill(params, cfg, _clone(prompt),
                           init_cache(cfg, B, CACHE, torch.float32))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1),
                                               dtype=np.int32))
        cases[(fam, "decode")] = (arch, "decode", "",
                                  (params, tokens, cache))
    arch = ARCHS["dense"]
    cfg = _cfg(arch)
    params = _params(arch, 99)
    rng = np.random.default_rng(99)
    cases[("dense", "forward_flash")] = (arch, "forward", "flash",
                                         (params, _batch(cfg, rng)))
    cases[("dense", "plain_train_seq")] = (arch, "plain_train", "seq",
                                           (params, _batch(cfg, rng)))
    # the cloud's test targets are the global model's own predictions, so
    # the nodes' accuracies spread and Alg. 2 keeps only some of them
    nodes = _batch(cfg, rng, lead=(FCFG.n_nodes, FCFG.local_steps), b=2,
                   s=8)
    evalb = _batch(cfg, rng, b=2, s=8)
    evalb["targets"] = forward(params, cfg, evalb)[0].argmax(-1).to(
        torch.int32)
    cases[("dense", "fed_train")] = (arch, "fed_train", "",
                                     (params, nodes, evalb, FED_KEY))
    return cases


def _step(cfg, kind, **kw):
    if kind == "forward":
        return lambda p, b: forward(p, cfg, b)
    return steps.make_step(cfg, kind, fcfg=FCFG, **kw)


def _ref_step(arch, kind, variant):
    """The reference's step, jitted."""
    cfg = _jcfg(arch, variant)
    if kind == "forward":
        return jax.jit(lambda p, b: j_forward(p, cfg, b))
    return jax.jit(jsteps.make_step(cfg, kind, fcfg=JFed(**FKW)))


def _to_jax(a):
    """A step's argument (tensors, numpy arrays, dict trees) as JAX
    arrays, the same values."""
    if isinstance(a, dict):
        return {k: _to_jax(v) for k, v in a.items()}
    if isinstance(a, torch.Tensor):
        return jnp.asarray(a.numpy())
    return jnp.asarray(a)


class _Routing:
    """`models.moe.top_k` recorded (``pinned`` None) or pinned to
    recorded choices, the gates this run's probabilities at them; counts
    the tokens whose own choice differs."""

    def __init__(self, pinned=None):
        self.pinned, self.calls, self.moved = pinned, [], 0

    def __enter__(self):
        real = self.real = moe.top_k

        def top_k(probs, k):
            if self.pinned is None:
                vals, idx = real(probs, k)
                self.calls.append(idx)
                return vals, idx
            idx = self.pinned[len(self.calls) % len(self.pinned)]
            own = real(probs, k)[1]
            self.calls.append(idx)
            self.moved += int((torch.sort(own, -1)[0]
                               != torch.sort(idx, -1)[0]).any(-1).sum())
            return torch.gather(probs, -1, idx), idx

        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        moe.top_k = self.real


def _host(t):
    """Every tensor of a step's output as a numpy array, in order."""
    if isinstance(t, dict):
        return [y for k in sorted(t) for y in _host(t[k])]
    if isinstance(t, (tuple, list)):
        return [y for e in t for y in _host(e)]
    if isinstance(t, torch.Tensor):
        if type(t) is not torch.Tensor:
            t = t.full_tensor()
        return [t.detach().to(torch.float32).numpy()
                if t.is_floating_point() else t.numpy()]
    if isinstance(t, np.ndarray):
        return [t.astype(np.float32) if np.issubdtype(t.dtype, np.floating)
                else t]
    return []


# What every rank runs: the sharded step of every case on the (2, 2)
# mesh, rank 0 writing the results.  It imports the port only.
RANK_SCRIPT = textwrap.dedent("""
    import logging, os, pickle, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=300))
    from repro_torch import tree
    from repro_torch.core import aldp
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm
    from repro_torch.sharding import ctx, rules
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    ns = {}
    exec(inp["fns"], ns)
    mesh = make_host_mesh(2, 2, device_type="cpu")
    dp = steps.dp_axes_for(mesh)
    # the channels (Mamba2: heads) each scan and decode step ran on
    widths = []
    def spy(name, width):
        real = getattr(ssm, name)
        def call(*a):
            widths.append(int(width(*a)))
            return real(*a)
        setattr(ssm, name, call)
    spy("_m1_chunked_scan", lambda x, *a: x.shape[-1])
    spy("_m2_chunked_scan", lambda x, *a: x.shape[2])
    spy("_m1_step_back", lambda p, cfg, xc, *a: xc.shape[-1])
    spy("_m2_step_ssd", lambda p, cfg, z, x, bc, dt, h, *a: h.shape[1])
    out = {}
    for case, (arch, kind, variant, args) in inp["cases"].items():
        cfg = ns["_cfg"](arch, variant)
        pk = "plain_train" if kind == "forward" else kind
        specs = steps.arg_pspecs(cfg, pk, mesh, args)
        placed = rules.place(mesh, tuple(ns["_clone"](a) for a in args),
                             specs)
        step = ns["_step"](
            cfg, kind, spmd_axes=dp if kind == "fed_train" else None,
            param_shardings=(rules.shardings_for(mesh, specs[0])
                             if kind == "plain_train" else None))
        widths.clear()
        calls = ssm.mixer_tp.calls
        with ns["_Routing"](inp["routing"].get(case)) as r, \\
                ctx.mesh_context(mesh, dp):
            res = step(*placed)
        out[case] = (ns["_host"](res), r.moved)
        if cfg.family in ("ssm", "hybrid"):
            states = None
            if kind in ("prefill", "decode"):
                want = rules.shardings_for(mesh, specs[2])["ssm"]
                states = {k: (str(tuple(v.placements)), str(want[k]))
                          for k, v in res[1]["ssm"].items()}
            out[("mixer",) + case] = (sorted(set(widths)),
                                      ssm.mixer_tp.calls - calls, states)
    # the noise on params placed over both mesh axes
    arch, kind, variant, args = inp["cases"][("dense", "fed_train")]
    cfg = ns["_cfg"](arch)
    params = rules.place(mesh, args[0], steps.arg_pspecs(
        cfg, "plain_train", mesh, args[:2])[0])
    noised = aldp.add_gaussian_noise(params, inp["noise_key"], 0.5, 1.0)
    out["noise"] = (ns["_host"](noised), sorted({
        str(tuple(x.placements)) for x in tree.leaves(params)}))
    dist.barrier()
    if rank == 0:
        with open(os.path.join(tmp, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()
""")


def _fns_source() -> str:
    import inspect
    head = ("import numpy as np\nimport torch\nfrom repro_torch import tree\n"
            "from repro_torch.configs import get_smoke_config\n"
            "from repro_torch.launch import steps\n"
            "from repro_torch.models import forward, moe\n"
            "from repro_torch.core.fed_step import FedStepConfig\n"
            f"FCFG = {FCFG!r}\n")
    return head + "\n".join(textwrap.dedent(inspect.getsource(f))
                            for f in (_cfg, _clone, _step, _Routing, _host))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks, compute the unsharded steps and the reference's
    here meanwhile, and collect rank 0's results (each rank waited on
    with a timeout)."""
    tmp = str(tmp_path_factory.mktemp("sharding_world"))
    cases = _inputs()
    routing, ref, jref = {}, {}, {}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    def unsharded(case):
        arch, kind, variant, args = cases[case]
        with _Routing() as r:
            res = _step(_cfg(arch, variant), kind)(
                *[_clone(a) for a in args])
        ref[case] = _host(res)
        if r.calls:
            routing[case] = r.calls

    # the MoE's routing first (the ranks pin theirs to it), the rest
    # while the ranks run
    routed = [c for c, v in cases.items() if _cfg(v[0]).family == "moe"]
    try:
        for case in routed:
            unsharded(case)
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump({"cases": cases, "routing": routing,
                         "noise_key": NOISE_KEY, "fns": _fns_source()}, f)
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(r), str(WORLD), store,
             tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(WORLD)]
        for case in cases:
            if case not in routed:
                unsharded(case)
        from repro_torch.core import aldp
        params = cases[("dense", "fed_train")][3][0]
        ref["noise"] = _host(aldp.add_gaussian_noise(params, NOISE_KEY,
                                                     0.5, 1.0))
        # the reference on the same inputs
        for case, (arch, kind, variant, args) in cases.items():
            res = _ref_step(arch, kind, variant)(*map(_to_jax, args))
            jref[case] = _host(jax.tree.map(np.asarray, res))
        noise = jax.jit(lambda t, k: jaldp.add_gaussian_noise(t, k, 0.5,
                                                              1.0))
        jref["noise"] = _host(jax.tree.map(np.asarray, noise(
            _to_jax(params), jnp.asarray(NOISE_KEY))))
    finally:
        torch.set_num_threads(n_threads)
    try:
        errs = []
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                errs.append(f"rank {r} exit {p.returncode}: {err[-3000:]}")
        assert not errs, "\n".join(errs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(os.path.join(tmp, "out.pkl"), "rb") as f:
        out = pickle.load(f)
    return {"out": out, "ref": ref, "jref": jref, "routing": routing}


def _max_diff(a, b):
    assert len(a) == len(b)
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(a, b))


STEP_CASES = [(fam, kind) for fam in ARCHS for kind in KINDS] \
    + [("dense", "forward_flash"), ("dense", "plain_train_seq")]


def _check_step(got, want, kind, logit_tol, param_tol):
    """A step's outputs within limits: params (a train step's) within
    ``param_tol``, the rest (logits, aux, caches, the loss) within
    ``logit_tol``."""
    assert [np.shape(x) for x in got] == [np.shape(x) for x in want]
    if kind.startswith("plain_train"):      # (params, loss)
        assert _max_diff(got[:-1], want[:-1]) <= param_tol
        assert _max_diff(got[-1:], want[-1:]) <= logit_tol
    else:                           # logits, aux / cache
        assert _max_diff(got, want) <= logit_tol


def _check_fed(got, want, logit_tol, param_tol):
    """Alg. 2's accuracies, threshold and count equal; params within
    ``param_tol``, losses and the mean norm within ``logit_tol``."""
    assert [np.shape(x) for x in got] == [np.shape(x) for x in want]
    n_params = len(got) - 6
    assert _max_diff(got[:n_params], want[:n_params]) <= param_tol
    # metrics in key order: delta_norm_mean, detect_threshold, loss,
    # n_normal, node_accuracies, node_losses
    gm, wm = got[n_params:], want[n_params:]
    for i in (1, 3, 4):             # threshold, mask count, accuracies
        assert np.array_equal(gm[i], wm[i])
    assert 0 < int(wm[3]) < FCFG.n_nodes     # Alg. 2 rejected some
    assert _max_diff([gm[k] for k in (0, 2, 5)],
                     [wm[k] for k in (0, 2, 5)]) <= logit_tol


@pytest.mark.parametrize("fam,kind", STEP_CASES)
def test_sharded_step_matches_unsharded(world, fam, kind):
    got, moved = world["out"][(fam, kind)]
    _check_step(got, world["ref"][(fam, kind)], kind, LOGIT_TOL, PARAM_TOL)
    if fam == "moe":
        assert (fam, kind) in world["routing"] and moved == 0


@pytest.mark.parametrize("fam,kind", STEP_CASES)
def test_sharded_step_matches_the_reference(world, fam, kind):
    """The reference's step on the same inputs: the unsharded port within
    the port's limits against it, the sharded port within those plus the
    cross-shard term."""
    want = world["jref"][(fam, kind)]
    _check_step(world["ref"][(fam, kind)], want, kind, REF_LOGIT_TOL,
                REF_PARAM_TOL)
    _check_step(world["out"][(fam, kind)][0], want, kind,
                REF_LOGIT_TOL + LOGIT_TOL, REF_PARAM_TOL + PARAM_TOL)


MAMBA_CASES = [(fam, kind) for fam in ("ssm", "hybrid") for kind in KINDS]


@pytest.mark.parametrize("fam,kind", MAMBA_CASES)
def test_mamba_mixer_runs_on_its_channel_block(world, fam, kind):
    """Each rank's scans (or decode steps) ran on d_inner / 2 channels
    (Mamba2: half the heads), through `ssm.mixer_tp` once a layer."""
    widths, calls, _ = world["out"][("mixer", fam, kind)]
    cfg = _cfg(ARCHS[fam])
    blocks = cfg.d_inner if fam == "ssm" else cfg.d_inner // cfg.ssm.head_dim
    assert calls == cfg.n_layers
    assert widths == [blocks // 2]


@pytest.mark.parametrize("fam,kind", [c for c in MAMBA_CASES
                                      if c[1] in ("prefill", "decode")])
def test_mamba_states_come_back_in_cache_placements(world, fam, kind):
    """Prefill and decode return every SSM state leaf ("h" split on
    d_inner or heads, Mamba2's "conv" on its even blocks of conv_dim) in
    `cache_pspecs`' placements, as they came in: batch on "data", a
    channel dim on "model"."""
    states = world["out"][("mixer", fam, kind)][2]
    assert set(states) == {"h", "conv"}
    for got, want in states.values():
        assert got == want and got.count("Shard") == 2


def test_sharded_fed_round_matches_unsharded(world):
    """Alg. 2's mask and accuracies equal; params and losses close."""
    got, _ = world["out"][("dense", "fed_train")]
    _check_fed(got, world["ref"][("dense", "fed_train")], LOGIT_TOL,
               PARAM_TOL)


def test_sharded_fed_round_matches_the_reference(world):
    """The reference's round (its noise `jax.random.normal` under the
    same key): Alg. 2's mask and accuracies equal, the unsharded port's
    params and losses within the port's limits, the sharded port's
    within those plus the cross-shard term."""
    want = world["jref"][("dense", "fed_train")]
    _check_fed(world["ref"][("dense", "fed_train")], want, REF_LOGIT_TOL,
               REF_PARAM_TOL)
    _check_fed(world["out"][("dense", "fed_train")][0], want,
               REF_LOGIT_TOL + LOGIT_TOL, REF_PARAM_TOL + PARAM_TOL)


def test_sharded_noise_is_the_unsharded_draw_bit_for_bit(world):
    got, placements = world["out"]["noise"]
    want = world["ref"]["noise"]
    assert any("Shard(dim=0)" in p and "Shard(dim=1)" in p
               for p in placements)        # split on both mesh axes
    assert all(np.array_equal(x, y) for x, y in zip(got, want))


def test_sharded_noise_is_the_reference_draw_bit_for_bit(world):
    """`repro.core.aldp.add_gaussian_noise` under the same key, jitted as
    `tests/test_torch_aldp_noise.py` holds it (XLA folds σS and contracts
    the add, which the port mirrors)."""
    got, _ = world["out"]["noise"]
    want = world["jref"]["noise"]
    assert len(got) == len(want)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
