"""The port's sharding rules, mesh context and mesh dry run
(`repro_torch.sharding`, `launch.mesh`, `launch.steps.arg_pspecs`,
`launch.dryrun --mesh/--multi-pod`).

* The rules against `repro.sharding` on `jax.sharding.AbstractMesh`: for
  every arch at its full config, on the 16x16 and 2x16x16 meshes, the
  specs of every param leaf, batch leaf and cache leaf of every shape
  equal the reference's (the port's rules take the JAX mesh itself: they
  read only its axis sizes).  JAX writes a one-axis entry ("data",) as
  "data", so entries are compared in that form.
* `sharding.ctx` is a no-op on plain tensors and outside a mesh, and
  changes no value on a mesh of one rank; the steps on that mesh are the
  unsharded steps bit for bit.
* `launch.mesh` refuses a missing group and a world size that is not the
  mesh's.
* The mesh dry run, in a subprocess under a fake process group of 256 or
  512 ranks: the record's mesh, per-device memory below the one-device
  record's, and the fed step's collectives; the Mamba families' records
  price their mixers tensor parallel on "model" where it cuts them into
  whole blocks (`mamba_mixer`), and replicated where it does not.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCH_IDS, get_config, long_context_variant
from repro.core.fed_step import FedStepConfig as JFed
from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro_torch.configs import get_config as tget
from repro_torch.configs import long_context_variant as tlong
from repro_torch.core.fed_step import FedStepConfig as TFed
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _entry(e):
    if isinstance(e, tuple):
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(_entry(e) for e in spec)
            for path, spec in flat}


def _port_specs(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, tuple) and tree and not all(
            e is None or isinstance(e, (str, tuple)) for e in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, f"{path}/{i}" if path else str(i)))
        return out
    return {path: tuple(_entry(e) for e in tree)}


def _cases(arch, n_dp):
    """(shape, step, fed nodes) for every input shape of an arch."""
    out = [("train_4k", "fed", n_dp), ("train_4k", "plain", 0),
           ("prefill_32k", "auto", 0), ("decode_32k", "auto", 0)]
    if arch != "whisper-large-v3":
        out.append(("long_500k", "auto", 0))
    return out


@pytest.fixture(scope="module")
def params_structs():
    """The port's params (meta tensors) per arch, traced once."""
    return {}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_reference_for_every_leaf(arch, params_structs):
    for mesh_name, (shape, names) in MESHES.items():
        mesh = AbstractMesh(shape, names)
        sizes = dict(zip(names, shape))
        n_dp = int(np.prod([sizes[a] for a in jsteps.dp_axes_for(mesh)]))
        assert tsteps.dp_axes_for(mesh) == jsteps.dp_axes_for(mesh)
        jcfg, tcfg = get_config(arch), tget(arch)
        assert tsteps.fsdp_axes_for(tcfg, mesh) == \
            jsteps.fsdp_axes_for(jcfg, mesh)
        for shape_name, step, nodes in _cases(arch, n_dp):
            jc, tc = jcfg, tcfg
            if shape_name == "long_500k":
                jc, tc = long_context_variant(jcfg), tlong(tcfg)
            jf = JFed(n_nodes=nodes, local_steps=4) if nodes else None
            tf = TFed(n_nodes=nodes, local_steps=4) if nodes else None
            jspec = jshapes.input_specs(jc, shape_name, step=step, fcfg=jf)
            if arch not in params_structs:   # a window changes no param
                params_structs[arch] = tshapes.params_struct(tc)
            tspec = tshapes.input_specs(tc, shape_name, step=step, fcfg=tf)
            targs = (params_structs[arch],) + tspec["args"][1:]
            kind = jspec["kind"]
            assert tspec["kind"] == kind
            want = _jax_specs(jsteps.arg_pspecs(jc, kind, mesh,
                                                jspec["args"]))
            got = _port_specs(tsteps.arg_pspecs(tc, kind, mesh, targs))
            assert got == want, (mesh_name, shape_name, {
                k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)})


def test_placements_follow_the_specs():
    """An entry ("pod", "data") shards its dim on both mesh dims; the
    stacked layer dim is never sharded; an axis not in the mesh raises."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.rules import placements_for

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert placements_for(Mesh, (None, ("pod", "data"), "model")) == \
        (Shard(1), Shard(1), Shard(2))
    assert placements_for(Mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="not in the mesh"):
        placements_for(Mesh, ("expert",))


def test_ctx_is_a_no_op_off_a_mesh():
    from repro_torch.sharding import ctx

    x = torch.randn(4, 6, 8)
    assert ctx.active_mesh() is None
    for y in (ctx.constrain_batch(x, 0), ctx.constrain_axis(x, 2, "model"),
              ctx.weight(x), ctx.heads(x, True),
              ctx.like(x, x), ctx.to_layout(x, {0: "dp"}),
              ctx.placed_as(x, x)):
        assert y is x
    assert ctx.constrain_batch({"a": x})["a"] is x
    assert ctx.local(lambda a, b: a + b, (x, x), [None, None], None) \
        .equal(x + x)
    assert not ctx.shard_heads(x, 4, 2)
    with ctx.suspended():
        assert ctx.constrain_batch(x, 0) is x


def _init_group(tmp_path, world=1):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=world, rank=0)


@pytest.fixture
def one_thread():
    """One intra-op thread while the test runs: its thousands of small
    DTensor operations would otherwise each wake a thread pool that
    the other test workers' processes already oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_meshes_refuse_a_missing_group_or_a_wrong_world(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh)

    with pytest.raises(ValueError, match="init_process_group"):
        make_host_mesh(1, 1, device_type="cpu")
    _init_group(tmp_path)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_host_mesh(2, 2, device_type="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True, device_type="cpu")
        mesh = make_host_mesh(1, 1, device_type="cpu")
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
    finally:
        dist.destroy_process_group()


def test_steps_on_a_mesh_of_one_are_the_unsharded_steps(tmp_path,
                                                        one_thread):
    """On a (data 1, model 1) mesh every shard is the whole tensor, so
    no redistribution moves anything and each step's values are the
    unsharded port's bit for bit: the scoring forward, prefill, decode, the SFL
    step and the fed round (dense smoke config, float32)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_cache, init_params, loss_fn
    from repro_torch.sharding import ctx, rules

    cfg = get_smoke_config("smollm-360m")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)

    def batch(lead=(), b=2, s=8):
        return {"tokens": torch.randint(0, cfg.vocab, lead + (b, s),
                                        generator=g, dtype=torch.int32),
                "targets": torch.randint(0, cfg.vocab, lead + (b, s),
                                         generator=g, dtype=torch.int32)}

    def host(t):
        if isinstance(t, dict):
            return [host(x) for x in tree.leaves(t)]
        return (t.full_tensor() if ctx.is_dtensor(t) else t).detach()

    def same(a, b):
        fa, fb = tree.leaves(a), tree.leaves(b)
        return len(fa) == len(fb) and all(
            torch.equal(host(x), host(y)) for x, y in zip(fa, fb))

    fcfg = TFed(n_nodes=2, local_steps=1, sigma=1e-3, detect=True,
                detect_s=50.0)
    prompt = {"tokens": batch()["tokens"]}
    cases = {
        "plain_train": (params, batch()),
        "prefill": (params, prompt, init_cache(cfg, 2, 16, torch.float32)),
        "decode": (params, batch(s=1)["tokens"],
                   init_cache(cfg, 2, 16, torch.float32)),
        "fed_train": (params, batch((2, 1)), batch(),
                      np.array([3, 4], np.uint32)),
    }

    def clone(t):
        if isinstance(t, dict):
            return tree.map(lambda x: x.clone(), t)
        return t.clone() if isinstance(t, torch.Tensor) else t

    _init_group(tmp_path)
    try:
        mesh = make_host_mesh(1, 1, device_type="cpu")
        dp = tsteps.dp_axes_for(mesh)
        for kind, args in cases.items():
            ref = tsteps.make_step(cfg, kind, fcfg=fcfg)(
                *[clone(a) for a in args])
            specs = tsteps.arg_pspecs(cfg, kind, mesh, args)
            placed = rules.place(mesh, tuple(clone(a) for a in args), specs)
            step = tsteps.make_step(
                cfg, kind, fcfg=fcfg,
                spmd_axes=dp if kind == "fed_train" else None,
                param_shardings=rules.shardings_for(mesh, specs[0]))
            with ctx.mesh_context(mesh, dp):
                out = step(*placed)
            for a, b in zip(out, ref):
                assert same(a, b), kind
        b = batch()
        placed = rules.place(mesh, (params, b), tsteps.arg_pspecs(
            cfg, "plain_train", mesh, (params, b)))
        with ctx.mesh_context(mesh, dp):
            x = placed[1]["tokens"]
            assert ctx.is_dtensor(x)
            assert torch.equal(host(ctx.constrain_batch(x, 0)), host(x))
            assert torch.equal(host(ctx.constrain_axis(x, 1)), host(x))
            loss = loss_fn(placed[0], cfg, placed[1])[0]
        assert torch.equal(host(loss), loss_fn(params, cfg, b)[0])
    finally:
        dist.destroy_process_group()


def _dryrun(*args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(r.stdout)


def test_seq_parallel_mesh_dryrun(one_thread):
    """``--seq-parallel`` on the 16x16 mesh: the SFL step of smollm's
    smoke config with the residual stream's sequence on "model" between
    blocks traces (the head gathers it back) and prices other
    collectives than the step without it."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "smollm-360m", "--shape", "train_4k", "--step", "plain",
           "--smoke", "--mesh", "16x16"]
    procs = [subprocess.Popen(cmd + extra, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for extra in ([], ["--seq-parallel"])]
    recs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:] + err[-3000:]
        recs.append(json.loads(out))
    plain, seq = recs
    assert plain["status"] == seq["status"] == "ok"
    assert "seq_parallel" not in plain and seq["seq_parallel"] is True
    assert seq["step_kind"] == "plain_train" and seq["mesh"] == "16x16"
    assert seq["collectives"]["total_bytes_per_device"] > 0
    assert seq["collectives"]["count_by_type"] \
        != plain["collectives"]["count_by_type"]


def test_mesh_dryruns_under_a_fake_group(one_thread):
    """Smoke configs on both meshes: the multi-pod decode step and the
    16x16 fed round (16 nodes, one per data rank, 4 local steps)."""
    from repro_torch.launch.dryrun import run_dryrun

    one = run_dryrun("smollm-360m", "decode_32k", smoke=True)
    pod = _dryrun("--arch", "smollm-360m", "--shape", "decode_32k",
                  "--smoke", "--multi-pod")
    assert pod["status"] == "ok" and pod["mesh"] == "2x16x16"
    assert pod["devices"] == 512 and pod["step_kind"] == "decode"
    assert 0 < pod["memory"]["per_device_total_gib"] \
        < one["memory"]["per_device_total_gib"]
    assert pod["memory"]["argument_size_in_bytes"] \
        < one["memory"]["argument_size_in_bytes"] / 16
    assert 0 < pod["cost"]["flops"] < one["cost"]["flops"]
    assert pod["collectives"]["total_bytes_per_device"] > 0
    assert pod["roofline"]["collective_s"] > 0

    fed = _dryrun("--arch", "smollm-360m", "--shape", "train_4k", "--smoke",
                  "--mesh", "16x16")
    assert fed["status"] == "ok" and fed["mesh"] == "16x16"
    assert fed["step_kind"] == "fed_train"
    assert fed["fed_layout"] == {"nodes": 16, "local_steps": 4,
                                 "per_node_batch": 4}
    coll = fed["collectives"]
    assert coll["total_bytes_per_device"] > 0
    assert coll["count_by_type"].get("all_gather_into_tensor", 0) > 0
    assert sum(coll["bytes_by_type"].values()) == \
        coll["total_bytes_per_device"]


# A dry run of a config changed from the arch's smoke config: argv arch,
# shape, mesh, ssm chunk, then JSON {field: value} for the config and
# {field: value} for its SSMConfig.
_CHANGED_DRYRUN = """
import dataclasses, json, sys
from repro_torch.launch import dryrun
arch, shape, mesh, chunk = sys.argv[1:5]
top, ssm = json.loads(sys.argv[5]), json.loads(sys.argv[6])
real = dryrun.resolve_config
def resolve(*a, **k):
    cfg = real(*a, **k).replace(**top)
    return cfg.replace(ssm=dataclasses.replace(cfg.ssm, **ssm))
dryrun.resolve_config = resolve
print(json.dumps(dryrun.run_dryrun(arch, shape, mesh=mesh, smoke=True,
                                   ssm_chunk=int(chunk)), default=str))
"""


def test_mamba_mesh_dryruns_price_the_mixer_tensor_parallel(one_thread):
    """On 16x16 the Mamba mixers split over "model": falcon-mamba's smoke
    ``prefill_32k`` counts what the model needs (useful_flops_ratio at
    least 0.5; replicated on "model", each rank ran its whole mixer and
    the record read 0.079), and so does zamba2's without its shared
    attention block: at 32,768 tokens the smoke config's attention (4
    heads, which 16 does not cut, so replicated on "model") is 93% of
    the flops, and no mixer route moves it.  A zamba2 whose 8 heads 16
    does not divide traces its mixers replicated, and says so.  The scan
    chunks are raised so the trace walks fewer of them (Mamba1's counted
    matmul flops do not depend on the chunk; Mamba2's grow with it, so
    its ratio read 1.07 at chunk 64 and 0.85 at 256)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    runs = {"falcon": ("falcon-mamba-7b", "prefill_32k", "512", {}, {}),
            "zamba2": ("zamba2-1.2b", "prefill_32k", "256",
                       {"attn_every": 0}, {}),
            "zamba2_as_is": ("zamba2-1.2b", "decode_32k", "0", {}, {}),
            "indivisible": ("zamba2-1.2b", "decode_32k", "0", {},
                            {"head_dim": 64})}
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", _CHANGED_DRYRUN, arch, shape, "16x16",
         chunk, json.dumps(top), json.dumps(ssm)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for k, (arch, shape, chunk, top, ssm) in runs.items()}
    recs = {}
    for k, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:] + err[-3000:]
        recs[k] = json.loads(out.strip().splitlines()[-1])
    for k, rec in recs.items():
        assert rec["status"] == "ok" and rec["mesh"] == "16x16", k
        tp = rec["mamba_mixer"].startswith("tensor parallel on 'model'")
        assert tp == (k != "indivisible"), (k, rec["mamba_mixer"])
    assert recs["indivisible"]["mamba_mixer"].startswith(
        "replicated on 'model'")
    for k in ("falcon", "zamba2"):
        assert recs[k]["roofline"]["useful_flops_ratio"] >= 0.5, \
            (k, recs[k]["roofline"])
    # the tensor-parallel mixers' reductions are one rank's collectives
    assert recs["falcon"]["collectives"]["count_by_type"]["all_reduce"] \
        >= 2 * 2
