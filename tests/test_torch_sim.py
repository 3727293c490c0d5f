"""The port's simulation service against `repro.sim`.

* Kill and resume inside the port is bit for bit the uninterrupted run —
  sync, async and buffered, over the network with a diurnal trace, across
  an ``attack``, a ``nodes`` and a ``network`` event, the record stream
  rebuilt on resume.
* A checkpoint the JAX `SimService` wrote resumes in the port, and its
  tail matches the JAX uninterrupted run at `tests/test_torch_api.py`'s
  limits: t, version, bytes and rejections equal, accuracy within
  1/n_test, the net summary and epsilon equal, final params within 1e-4
  (local SGD sums in another order in XLA than in PyTorch).
* An empty `SimSpec` reproduces the batch run; the traffic math and the
  availability sampler equal the reference's."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.fleet import UniformSampler as JUniform
from repro.sim import DynamicSampler as JDynamic
from repro.sim import SimService as JSim
from repro.sim import modulation as jmodulation
from repro.sim import region_mask as jregion_mask
from repro_torch import api as tapi
from repro_torch import tree
from repro_torch.fleet import UniformSampler as TUniform
from repro_torch.sim import DynamicSampler as TDynamic
from repro_torch.sim import SimService as TSim
from repro_torch.sim import modulation as tmodulation
from repro_torch.sim import region_mask as tregion_mask

N_TEST = 128


def _recs(report):
    return [(r.t, r.version, r.accuracy, r.comm_bytes, r.comp_time,
             r.comm_time, r.n_rejected, r.bytes_source)
            for r in report.records]


def _spec(m, kind, events=True, records_jsonl=None, rounds=5):
    sim = m.SimSpec(
        traces=(m.TrafficTrace(kind="diurnal", period_s=30.0,
                               amplitude=0.4),),
        events=(m.SimEvent(at_round=1, kind="attack", payload={
                    "malicious_frac": 0.5, "kind": "label_flip"}),
                m.SimEvent(at_round=2, kind="nodes", payload={"leave": [0]}),
                m.SimEvent(at_round=3, kind="network",
                           payload={"latency_s": 0.05})) if events else ())
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=8, model="mlp", hw=(8, 8),
                          samples_per_node=30, n_test=N_TEST,
                          n_cloud_test=64),
        schedule=m.SchedulePolicy(kind=kind),
        privacy=m.PrivacySpec(sigma=0.05),
        compression=m.CompressionSpec(sparsify_ratio=0.2),
        defense=m.DefenseSpec(detect=True),
        network=m.NetworkSpec(codec="sparse_coo", bandwidth_sigma=0.3,
                              latency_s=0.01),
        obs=m.ObsSpec(enabled=records_jsonl is not None,
                      records_jsonl=records_jsonl),
        topology=m.Topology(backend="pallas"),
        train=m.TrainSpec(local_steps=2, batch_size=8, lr=0.1),
        rounds=rounds, seed=0, sim=sim)


@pytest.fixture(scope="module")
def uninterrupted():
    """kind -> the port's uninterrupted service run of `_spec`."""
    return {kind: TSim(tapi.compile_plan(_spec(tapi, kind)),
                       device="cpu").run()
            for kind in ("sync", "async", "buffered")}


@pytest.mark.parametrize("kill_at", [1, 2, 4])
@pytest.mark.parametrize("kind", ["sync", "async", "buffered"])
def test_kill_and_resume_is_bitwise(uninterrupted, tmp_path, kind,
                                    kill_at):
    base = uninterrupted[kind]
    stream = str(tmp_path / "records.jsonl")
    spec = _spec(tapi, kind, records_jsonl=stream)
    svc = TSim(tapi.compile_plan(spec), device="cpu")
    svc.run(max_records=kill_at)
    path = svc.checkpoint(str(tmp_path / "ck"))
    del svc                                 # the kill
    rep = TSim.resume(path, device="cpu").run()
    assert _recs(rep) == _recs(base)
    assert (rep.detections, rep.net, rep.epsilon_spent) == \
        (base.detections, base.net, base.epsilon_spent)
    assert rep.resumed_from == path and rep.resume_round == kill_at
    for a, b in zip(tree.leaves(base.final_params),
                    tree.leaves(rep.final_params)):
        assert torch.equal(a, b)
    assert _recs(tapi.replay_records(stream)) == _recs(base)


def test_events_and_traces_move_the_run(uninterrupted):
    quiet = TSim(tapi.compile_plan(_spec(tapi, "async", events=False)),
                 device="cpu").run()
    assert _recs(quiet) != _recs(uninterrupted["async"])
    plain = tapi.run(tapi.compile_plan(dataclasses.replace(
        _spec(tapi, "async", events=False), sim=None)), device="cpu")
    assert _recs(plain) != _recs(quiet)


def test_empty_simspec_service_matches_batch_run():
    spec = dataclasses.replace(_spec(tapi, "async", events=False), sim=None)
    base = tapi.run(tapi.compile_plan(spec), device="cpu")
    routed = tapi.run(tapi.compile_plan(dataclasses.replace(
        spec, sim=tapi.SimSpec())), device="cpu")
    assert _recs(routed) == _recs(base)
    assert routed.resumed_from is None and routed.resume_round is None
    for a, b in zip(tree.leaves(base.final_params),
                    tree.leaves(routed.final_params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["sync", "async", "buffered"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, kind):
    """The JAX service checkpoints after record 2 and runs on (its run
    is the uninterrupted one: the reference resumes bit-exactly); the
    port resumes from the file and reaches the same tail."""
    spec = _spec(japi, kind)
    svc = JSim(japi.compile_plan(spec))
    svc.run(max_records=2)
    path = svc.checkpoint(str(tmp_path / "jax_ck"))
    base = svc.run()
    rep = TSim.resume(path, device="cpu").run()
    assert rep.resume_round == 2 and len(rep.records) == len(base.records)
    for a, b in zip(base.records, rep.records):
        assert (a.t, a.version, a.comm_bytes, a.n_rejected,
                a.bytes_source) == (b.t, b.version, b.comm_bytes,
                                    b.n_rejected, b.bytes_source)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / N_TEST
    assert rep.net == base.net and rep.epsilon_spent == base.epsilon_spent
    assert rep.detections == base.detections
    for a, b in zip(jax.tree.leaves(base.final_params),
                    tree.leaves(rep.final_params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-4)


TRACES = [
    dict(kind="diurnal", period_s=40.0, amplitude=0.3, phase_s=5.0),
    dict(kind="flash_crowd", t_start=3.0, duration_s=10.0, node_frac=0.3,
         region_start=0.8, amplitude=0.6),
    dict(kind="outage", t_start=1.0, duration_s=4.0, node_frac=0.25,
         region_start=0.1),
]


@pytest.mark.parametrize("t", [0.0, 2.0, 3.5, 12.9, 13.0, 40.0])
def test_modulation_matches_the_reference(t):
    jt = tuple(japi.TrafficTrace(**d) for d in TRACES)
    tt = tuple(tapi.TrafficTrace(**d) for d in TRACES)
    for k in range(1, 4):
        sj, uj = jmodulation(jt[:k], 10, t)
        st, ut = tmodulation(tt[:k], 10, t)
        np.testing.assert_array_equal(uj, ut)
        assert (sj is None) == (st is None)
        if sj is not None:
            assert sj.tobytes() == st.tobytes()
    for frac, start in ((0.3, 0.8), (1.0, 0.0), (0.01, 0.99)):
        np.testing.assert_array_equal(jregion_mask(10, frac, start),
                                      tregion_mask(10, frac, start))


def test_dynamic_sampler_matches_the_reference():
    up = np.array([True, False] * 5)
    for inner in (None, "uniform"):
        dj = JDynamic(10, inner=JUniform(4, seed=3) if inner else None)
        dt = TDynamic(10, inner=TUniform(4, seed=3) if inner else None)
        dj.up, dt.up = up, up
        for r in range(4):
            for a, b in zip(dj.cohort(r, 10), dt.cohort(r, 10)):
                np.testing.assert_array_equal(a, b)


def test_service_refuses_what_the_reference_refuses(tmp_path):
    spec = _spec(tapi, "async")
    pop = tapi.materialize(spec, device="cpu")
    with pytest.raises(ValueError, match="attack SimEvents"):
        TSim(tapi.compile_plan(spec), population=pop, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TSim(tapi.compile_plan(spec), checkpoint_every=2, device="cpu")
    svc = TSim(tapi.compile_plan(_spec(tapi, "sync", events=False,
                                       rounds=2)),
               checkpoint_dir=str(tmp_path), checkpoint_every=1,
               device="cpu")
    svc.run()
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_000001.json", "ckpt_000001.npz", "ckpt_000002.json",
        "ckpt_000002.npz"]
    with pytest.raises(RuntimeError, match="already complete"):
        svc.step()
    with pytest.raises(ValueError, match="not a SimService checkpoint"):
        from repro_torch.checkpointing import save_checkpoint
        save_checkpoint(str(tmp_path / "plain"), {"a": np.zeros(1)})
        TSim.resume(str(tmp_path / "plain"), device="cpu")
