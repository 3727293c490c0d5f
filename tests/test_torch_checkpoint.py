"""The port's checkpoints against `repro.checkpointing`.

One tree saved by both packages gives the same manifest (step, keys,
dtypes, extra) and the same stored arrays; each package loads the
other's file; bfloat16 survives a round trip with `ml_dtypes` blocked;
the `CheckpointError` cases are the reference's; and an engine's
`export_sim_state` snapshot has the reference's names and dtypes and
restores bit for bit into a fresh engine."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpointing as jck
from repro_torch import api, tree
from repro_torch import checkpointing as tck


def _trees():
    """The same tree for each package: nested dicts, a list, a tuple, a
    None leaf, and every dtype a run snapshot holds (bfloat16 too)."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    bf = rng.normal(size=(5,)).astype(jnp.bfloat16)
    common = {
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "u32": np.array([0, 7], np.uint32),
        "i64": np.arange(4, dtype=np.int64),
        "f64": rng.normal(size=(4,)),
        "flags": np.array([True, False, True]),
        "scalar": np.asarray(3, np.int32),
        "ring": np.array([0.5, np.nan, 0.25], np.float32),
    }
    ref = dict(common, params={"b": {"w": f32}, "a": jnp.asarray(f32[0])},
               seq=[np.float32(1.5) * np.ones(2, np.float32), None],
               pair=(np.zeros(1, np.int32), np.ones(1, np.int32)),
               bf16=bf)
    port = dict(common, params={"b": {"w": torch.from_numpy(f32.copy())},
                                "a": torch.from_numpy(f32[0].copy())},
                seq=[np.float32(1.5) * np.ones(2, np.float32), None],
                pair=(np.zeros(1, np.int32), np.ones(1, np.int32)),
                bf16=torch.from_numpy(bf.view(np.int16).copy()).view(
                    torch.bfloat16))
    return ref, port


def _npz(base):
    with np.load(base + ".npz") as d:
        return {k: d[k] for k in d.files}


def test_manifest_keys_dtypes_and_arrays_match_the_reference(tmp_path):
    ref, port = _trees()
    extra = {"sim_checkpoint": 1, "history": [{"t": 0.1}]}
    jck.save_checkpoint(str(tmp_path / "j.npz"), ref, step=7, extra=extra)
    tck.save_checkpoint(str(tmp_path / "t.npz"), port, step=7, extra=extra)
    with open(tmp_path / "j.json") as f:
        mj = json.load(f)
    with open(tmp_path / "t.json") as f:
        mt = json.load(f)
    assert mt == mj
    assert tck.read_manifest(str(tmp_path / "t")) == mj
    assert mj["dtypes"]["bf16"] == "bfloat16" and "seq/1" not in mj["keys"]
    aj, at = _npz(str(tmp_path / "j")), _npz(str(tmp_path / "t"))
    assert sorted(aj) == sorted(at) == mj["keys"]
    for k in aj:
        assert aj[k].dtype == at[k].dtype, k
        np.testing.assert_array_equal(aj[k], at[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_loads_the_others_checkpoint(tmp_path, writer):
    ref, port = _trees()
    base = str(tmp_path / "ck")
    if writer == "reference":
        jck.save_checkpoint(base, ref, step=3)
        got, step = tck.load_checkpoint(base, port)
        assert step == 3
        assert isinstance(got["params"]["b"]["w"], torch.Tensor)
        assert got["bf16"].dtype == torch.bfloat16
        assert got["seq"][1] is None and isinstance(got["pair"], tuple)
        for (a, b) in zip(jax.tree.leaves(ref), _leaves(got)):
            assert np.asarray(a).tobytes() == _np(b).tobytes()
    else:
        tck.save_checkpoint(base, port, step=3)
        got, step = jck.load_checkpoint(base, ref)
        assert step == 3
        for (a, b) in zip(jax.tree.leaves(got), _leaves(port)):
            assert np.asarray(a).tobytes() == _np(b).tobytes()


def _leaves(t):
    """Leaves in jax order (dict keys sorted, None dropped)."""
    if t is None:
        return []
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    return np.asarray(x)


def test_bf16_round_trip_without_ml_dtypes(tmp_path, monkeypatch):
    """With `ml_dtypes` unimportable, bf16 tensors save and load bit for
    bit (the port goes through `Tensor.view`)."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes as _  # noqa: F401
    x = torch.randn(7, 3, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    x[0, 0] = float("nan")
    x[1, 1] = -0.0
    t = {"w": x, "v": [x[2]]}
    base = str(tmp_path / "bf")
    tck.save_checkpoint(base, t, step=1)
    assert tck.read_manifest(base)["dtypes"] == {"v/0": "bfloat16",
                                                 "w": "bfloat16"}
    like = {"w": torch.zeros_like(x), "v": [torch.zeros_like(x[2])]}
    got, _ = tck.load_checkpoint(base, like)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(got["v"][0].view(torch.int16),
                       x[2].view(torch.int16))


ERRORS = {
    "missing-leaf": lambda d: (d, {"a": np.zeros(2), "b": np.zeros(1)}),
    "shape": lambda d: (d, {"a": np.zeros(3)}),
    "manifest": lambda d: (os.path.join(d, "nowhere"), None),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_checkpoint_errors_are_the_references(tmp_path, case):
    base = str(tmp_path / "ck")
    jck.save_checkpoint(base, {"a": np.zeros(2)})
    path, like = ERRORS[case](base)
    for mod in (jck, tck):
        with pytest.raises(mod.CheckpointError) as e:
            if like is None:
                mod.read_manifest(path)
            else:
                mod.load_checkpoint(path, like)
        if mod is jck:
            want = str(e.value)
        else:
            assert str(e.value) == want


def _engine(kind):
    spec = api.ExperimentSpec(
        fleet=api.FleetSpec(n_nodes=6, model="cnn", hw=(14, 14),
                            samples_per_node=20, n_test=32, n_cloud_test=32,
                            attack=api.AttackMix(malicious_frac=0.34,
                                                 kind="adaptive")),
        schedule=api.SchedulePolicy(kind=kind),
        privacy=api.PrivacySpec(sigma=0.05),
        compression=api.CompressionSpec(sparsify_ratio=0.1),
        defense=api.DefenseSpec(detect=True, kind="trust_weighted",
                                detect_window=16),
        topology=api.Topology(backend="pallas"), rounds=1)
    plan = api.compile_plan(spec)
    return api.make_engine(plan, api.materialize(spec, device="cpu"),
                           device="cpu")


SNAPSHOT_DTYPES = {
    "sync": {"chain_key": "uint32", "trust": "float32",
             "throttle": "float32"},
    "async": {"chain_key": "uint32", "trust": "float32",
              "throttle": "float32", "next_arrival": "float32",
              "dispatched_version": "int32", "version": "int32",
              "acc_ring": "float32", "acc_count": "int32"},
}


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_engine_snapshot_names_dtypes_and_bitwise_restore(tmp_path, kind):
    """`export_sim_state` holds the reference's names in its dtypes;
    saved, loaded and restored into a fresh engine, the next round or
    window is bit for bit the original's."""
    eng = _engine(kind)
    step = eng.run_round if kind == "sync" else eng.run_window
    step()
    snap = eng.export_sim_state()
    want = SNAPSHOT_DTYPES[kind]
    assert {k: str(v.dtype) for k, v in snap.items()
            if k in want} == want
    assert set(snap) - set(want) == ({"params", "residuals"} if kind ==
                                     "sync" else
                                     {"params", "residuals", "dispatched"})
    if kind == "async":
        assert snap["version"].shape == () and snap["acc_count"].shape == ()
        assert np.isnan(snap["acc_ring"]).any()
    base = str(tmp_path / "eng")
    tck.save_checkpoint(base, snap)
    loaded, _ = tck.load_checkpoint(base, eng.export_sim_state())
    fresh = _engine(kind)
    fresh.load_sim_state(loaded)
    if kind == "sync":      # what the sync stepper's restore sets
        fresh.state.round = eng.state.round
        fresh._t0 = eng.history[-1].t
    else:
        fresh._window_idx = eng._window_idx
    a, b = step(), (fresh.run_round if kind == "sync"
                    else fresh.run_window)()
    assert a == b
    for x, y in zip(tree.leaves(eng.params), tree.leaves(fresh.params)):
        assert torch.equal(x, y)
    assert fresh.state.acc_ring is None or (
        fresh.state.acc_ring.dtype == torch.float32
        and fresh.state.acc_ring.device.type == "cpu")
