"""The port's launch tooling (`repro_torch.launch.{shapes,roofline,cost,
dryrun,dryrun_all}` and `configs.paper_cnn`) against `repro.launch`.

Shapes and dtypes of every step input equal the reference's for every
arch × shape (smoke configs; the port's stand-ins are meta tensors);
`fed_layout`, the paper's CNN config, `model_flops`, `attention_flops` and
`analytic_memory_bytes` equal the reference's exactly (the same float
arithmetic on the same config numbers).  The cost pass's matmul flops on
a 2-layer smoke config equal JAX `hlo_cost`'s dot flops
exactly: both count 2·M·N·K for every matmul of the same shapes, and the
totals are integers far below 2^53 (every family read equal when this
was written; the dense and MoE forwards are tested).  A `run_dryrun` record for each
family's smoke config at each shape kind (train, prefill, decode), with
the fields the reference's records carry.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, get_smoke_config
from repro.configs import long_context_variant
from repro.core.fed_step import FedStepConfig as JFed
from repro.launch import roofline as jrl
from repro.launch import shapes as jshapes
from repro_torch import tree
from repro_torch.configs import get_config as tget
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.configs import long_context_variant as tlong
from repro_torch.core.fed_step import FedStepConfig as TFed
from repro_torch.launch import roofline as trl
from repro_torch.launch import shapes as tshapes

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILIES = {"dense": "smollm-360m", "moe": "kimi-k2-1t-a32b",
            "ssm": "falcon-mamba-7b", "hybrid": "zamba2-1.2b",
            "vlm": "qwen2-vl-72b", "audio": "whisper-large-v3"}


def _flat(t):
    if isinstance(t, (tuple, list)):
        return [x for e in t for x in _flat(e)]
    return tree.leaves(t)


def test_shapes_and_fed_layout_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.LONG_SKIP == jshapes.LONG_SKIP
    for n, h in ((16, 4), (32, 4), (4, 2), (64, 4)):
        assert tshapes.fed_layout(tshapes.SHAPES["train_4k"], n, h) == \
            jshapes.fed_layout(jshapes.SHAPES["train_4k"], n, h)
    with pytest.raises(ValueError, match="does not cover"):
        tshapes.fed_layout(tshapes.SHAPES["train_4k"], 128, 4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Every shape of the arch's smoke config (its long-context variant at
    long_500k): the same step kind, leaves in the same order with the same
    shapes and dtypes, every port leaf on the meta device."""
    jf, tf = JFed(n_nodes=16, local_steps=4), TFed(n_nodes=16, local_steps=4)
    for name in jshapes.SHAPES:
        jc, tc = get_smoke_config(arch), tsmoke(arch)
        if name == "long_500k":
            if arch in jshapes.LONG_SKIP:
                continue
            jc, tc = long_context_variant(jc), tlong(tc)
        for step in (("auto", "plain") if name == "train_4k" else ("auto",)):
            a = jshapes.input_specs(jc, name, step=step, fcfg=jf)
            b = tshapes.input_specs(tc, name, step=step, fcfg=tf)
            assert a["kind"] == b["kind"]
            want = [(tuple(x.shape), str(x.dtype))
                    for x in jax.tree.leaves(a["args"])]
            got = _flat(b["args"])
            assert all(x.device.type == "meta" for x in got)
            assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                    for x in got] == want, (arch, name, step)


def test_paper_cnn_config_matches_reference():
    from repro.configs.paper_cnn import config as jcfg
    from repro_torch.configs.paper_cnn import config as tcfg

    a, b = jcfg(), tcfg()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.hw, a.channels) == (b.hw, b.channels)
    cifar = dataclasses.replace(b, dataset="cifar")
    assert (cifar.hw, cifar.channels) == ((32, 32), 3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_and_attention_flops_and_memory_floor_match_reference(arch):
    for full in (True, False):
        jc = get_config(arch) if full else get_smoke_config(arch)
        tc = tget(arch) if full else tsmoke(arch)
        for kind in ("fed_train", "plain_train", "prefill", "decode"):
            assert trl.model_flops(tc, kind, 524288) == \
                jrl.model_flops(jc, kind, 524288)
            for shape in jshapes.SHAPES.values():
                assert trl.attention_flops(tc, kind, shape.global_batch,
                                           shape.seq_len) == \
                    jrl.attention_flops(jc, kind, shape.global_batch,
                                        shape.seq_len)
            assert trl.attention_flops(tlong(tc), kind, 1, 524288) == \
                jrl.attention_flops(long_context_variant(jc), kind, 1,
                                    524288)
            kw = dict(params_bytes=1.5e12, cache_bytes=3.2e9,
                      act_ckpt_bytes=7.7e8, logits_bytes=1.1e9, n_dev=1,
                      moe_expert_frac=0.25)
            assert trl.analytic_memory_bytes(kind, **kw) == \
                jrl.analytic_memory_bytes(kind, **kw)


def test_roofline_terms_on_the_h100_table():
    t = trl.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == \
        pytest.approx((1.0, 2.0, 0.5), rel=1e-12)
    assert t["dominant"] == "memory_s" and t["bound_fraction"] == 0.5
    f32 = trl.roofline_terms(67e12, 0.0, 0.0, peak=trl.PEAK_F32)
    assert f32["compute_s"] == pytest.approx(1.0) and \
        f32["dominant"] == "compute_s" and f32["bound_fraction"] == 1.0
    assert trl.PEAKS["bfloat16"] == 989e12 and trl.PEAKS["float32"] == 67e12
    assert trl.mfu(989e12 * 0.25, 1.0) == pytest.approx(0.25)


def _forward_batch(jc, b=2, s=64):
    batch = {}
    if jc.family == "vlm":
        batch["patches"] = (b, jc.n_patches, jc.d_model)
        s -= jc.n_patches
    if jc.family == "audio":
        batch["frames"] = (b, jc.n_audio_frames, jc.d_model)
    batch["tokens"] = (b, s)
    return batch


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_cost_matmul_flops_equal_hlo_cost_dot_flops(family):
    """A 2-layer smoke forward (dense, and the MoE's grouped expert
    products): the fake-tensor pass's flops (matmuls via
    `torch.utils.flop_counter`) equal the dot flops of JAX `hlo_cost` on
    the compiled forward, exactly."""
    from repro.launch.hlo_cost import analyze_hlo_text
    from repro.models import forward as jforward
    from repro.models import init_params as jinit
    from repro_torch.launch.cost import step_cost
    from repro_torch.models import forward as tforward

    arch = FAMILIES[family]
    jc, tc = get_smoke_config(arch), tsmoke(arch)
    shapes = _forward_batch(jc)
    jb = {k: (jnp.zeros(v, jnp.int32) if k == "tokens"
              else jnp.zeros(v, jnp.float32)) for k, v in shapes.items()}
    tb = {k: tshapes.meta(v, torch.int32 if k == "tokens"
                          else torch.float32) for k, v in shapes.items()}
    hlo = jax.jit(lambda p, b: jforward(p, jc, b)).lower(
        jinit(jc, jax.random.PRNGKey(0)), jb).compile().as_text()
    want = analyze_hlo_text(hlo).flops
    cost = step_cost(lambda p, b: tforward(p, tc, b),
                     tshapes.params_struct(tc), tb)
    assert want > 0 and cost.flops == want
    assert set(cost.flops_by_op) <= {"aten.mm", "aten.bmm", "aten.addmm"}
    assert cost.bytes > 0 and cost.peak_live_bytes > 0 and cost.n_ops > 0
    assert cost.coll_counts == {}


def _check_record(rec, kind):
    assert rec["status"] == "ok" and rec["step_kind"] == kind
    assert rec["devices"] == 1 and rec["collectives"]["count_by_type"] == {}
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["device_gb"] == 80
    assert mem["per_device_total_gib"] > 0 and isinstance(mem["fits"], bool)
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert "plain version" in rec["cost"]["attention"]
    r = rec["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "model_flops_global", "attention_flops_global",
                "useful_flops_ratio", "memory_lb_s", "dominant_lb"):
        assert key in r, key
    assert r["collective_s"] == 0.0 and r["memory_lb_s"] > 0
    assert r["dominant"] in ("compute_s", "memory_s")
    json.dumps(rec)


# the smoke configs' scan chunk of 8 would walk 4,096 chunks at 32k
# tokens; the chunk sets how many operations trace, not their kinds
SSM_CHUNK = {"ssm": 8192, "hybrid": 8192}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_dryrun_record_for_each_family_and_kind(family, shape):
    """The plain SFL step for the train shape (the fed step is the dense
    case below: its 16 × 4 node loop traces 64 local steps)."""
    from repro_torch.launch.dryrun import run_dryrun

    kind = {"train_4k": "plain_train", "prefill_32k": "prefill",
            "decode_32k": "decode"}[shape]
    rec = run_dryrun(FAMILIES[family], shape, smoke=True,
                     step="plain" if kind == "plain_train" else "auto",
                     ssm_chunk=SSM_CHUNK.get(family, 0))
    _check_record(rec, kind)


def test_run_dryrun_fed_train_and_refusals(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun_all
    from repro_torch.launch.dryrun import run_dryrun

    rec = run_dryrun("smollm-360m", "train_4k", smoke=True, n_nodes=1,
                     local_steps=1)
    _check_record(rec, "fed_train")
    assert rec["fed_layout"] == {"nodes": 1, "local_steps": 1,
                                 "per_node_batch": 256}
    assert rec["roofline"]["useful_flops_ratio"] > 0
    assert run_dryrun("whisper-large-v3", "long_500k")["status"] == "skipped"
    # dryrun_all runs a combination in its own process, whose record
    # lands in --out; a second call reads it back instead of running it
    monkeypatch.setenv("PYTHONPATH", SRC)
    got = dryrun_all.run_one("olmo-1b", "decode_32k", str(tmp_path),
                             smoke=True)
    assert got["status"] == "ok" and got["step_kind"] == "decode"
    path = tmp_path / "olmo-1b.decode_32k.1.smoke.json"
    assert set(os.listdir(tmp_path)) == {path.name}
    with open(path, "w") as f:
        json.dump({"status": "ok", "marker": 1}, f)
    again = dryrun_all.run_one("olmo-1b", "decode_32k", str(tmp_path),
                               smoke=True)
    assert again["marker"] == 1


def test_params_struct_allocates_nothing():
    """Full qwen2-vl-72b's params (73B) as meta tensors: the reference's
    shapes and dtypes, no storage."""
    leaves = tree.leaves(tshapes.params_struct(tget("qwen2-vl-72b")))
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in leaves) > 7e10
    want = jax.tree.leaves(jshapes.params_struct(get_config("qwen2-vl-72b")))
    assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in leaves] == [(tuple(x.shape), str(x.dtype))
                                 for x in want]
