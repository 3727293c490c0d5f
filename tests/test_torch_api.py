"""The port's API layer against `repro.api`.

One spec JSON (schema v6) loads in both packages; contradictory specs
raise the same `SpecError`; observability, the simulation service, the
mesh topology and the sequential reference loops compile into the
reference's plans; and the same
small runs through both `run()`s from one population (the reference's
params carried over) give the same records: equal t, comm_bytes,
n_rejected and detections, accuracy within 1/n_test, equal ε and κ,
final params within atol 1e-4 (local SGD sums in another order in XLA
than in PyTorch)."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import convert, tree


def _both(build):
    """The same spec built against each package's API module."""
    return build(japi), build(tapi)


def _rich(m):
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=12, model="cnn", hw=(14, 14),
                          profile=m.NodeHeterogeneity(straggler_frac=0.1),
                          attack=m.AttackMix(malicious_frac=0.25,
                                             kind="backdoor"),
                          iid=False),
        schedule=m.SchedulePolicy(kind="async", staleness_adaptive=True,
                                  window=m.FixedWindow(0.5)),
        privacy=m.PrivacySpec(sigma=None, epsilon=4.0),
        compression=m.CompressionSpec(sparsify_ratio=0.2),
        defense=m.DefenseSpec(detect=True, detect_window=16),
        obs=m.ObsSpec(enabled=True, health=m.HealthSpec(
            straggler_factor=3.0)),
        topology=m.Topology(backend="pallas"), rounds=3, seed=4)


def test_reference_spec_json_loads_and_round_trips():
    ref = _rich(japi)
    loaded = tapi.ExperimentSpec.from_json(ref.to_json())
    assert loaded == _rich(tapi)
    assert loaded.to_dict() == ref.to_dict()
    assert tapi.ExperimentSpec.from_json(loaded.to_json()) == loaded


CONTRADICTIONS = [
    lambda m: m.ExperimentSpec(schedule=m.SchedulePolicy(kind="bogus")),
    lambda m: m.ExperimentSpec(fleet=m.FleetSpec(n_nodes=0)),
    lambda m: m.ExperimentSpec(fleet=m.FleetSpec(availability=0.5,
                                                 cohort_frac=0.5)),
    lambda m: m.ExperimentSpec(topology=m.Topology(devices=2)),
    lambda m: m.ExperimentSpec(schedule=m.SchedulePolicy(
        staleness_adaptive=True)),
    lambda m: m.ExperimentSpec(schedule=m.SchedulePolicy(
        window=m.FixedWindow(1.0))),
    lambda m: m.ExperimentSpec(schedule=m.SchedulePolicy(
        kind="async", window=m.TargetArrivalsWindow(4))),
    lambda m: m.ExperimentSpec(network=m.NetworkSpec(loss_prob=0.1)),
    lambda m: m.ExperimentSpec(fleet=m.FleetSpec(attack=m.AttackMix(
        malicious_frac=0.2, flip_src=3, flip_dst=3))),
    lambda m: m.ExperimentSpec(defense=m.DefenseSpec(
        kind="trust_weighted")),
    lambda m: m.ExperimentSpec(obs=m.ObsSpec(events_jsonl="x.jsonl")),
    lambda m: m.ExperimentSpec(privacy=m.PrivacySpec(sigma=-1.0)),
    lambda m: m.ExperimentSpec(compression=m.CompressionSpec(
        sparsify_ratio=0.0)),
    lambda m: m.ExperimentSpec(rounds=3, sim=m.SimSpec(events=(
        m.SimEvent(at_round=5),))),
    lambda m: m.ExperimentSpec(topology=m.Topology(kind="sequential",
                                                   backend="pallas")),
]


@pytest.mark.parametrize("case", range(len(CONTRADICTIONS)))
def test_contradictory_specs_raise_the_same_spec_error(case):
    ref, port = _both(CONTRADICTIONS[case])
    with pytest.raises(japi.SpecError) as ej:
        japi.compile_plan(ref)
    with pytest.raises(tapi.SpecError) as et:
        tapi.compile_plan(port)
    assert str(ej.value) == str(et.value)


PORTED = [
    lambda m: m.ExperimentSpec(obs=m.ObsSpec(enabled=True)),
    lambda m: m.ExperimentSpec(sim=m.SimSpec()),
    lambda m: m.ExperimentSpec(topology=m.Topology(kind="mesh", devices=4)),
    lambda m: m.ExperimentSpec(topology=m.Topology(kind="sequential")),
]


@pytest.mark.parametrize("case", range(len(PORTED)))
def test_obs_and_sim_specs_compile_as_in_the_reference(case):
    """Observability, the simulation service, the mesh topology and the
    sequential reference loops are ported: both packages compile these
    specs into the same plan."""
    ref, port = _both(PORTED[case])
    tp, jp = tapi.compile_plan(port), japi.compile_plan(ref)
    assert (tp.stages, tp.engine, tp.mesh_devices) == \
        (jp.stages, jp.engine, jp.mesh_devices)


def _full_network(m):
    return m.NetworkSpec(codec="sparse_bitpack", value_bits=16,
                         bandwidth_sigma=0.5, latency_s=0.01, jitter_s=0.2,
                         loss_prob=0.1, mtu_bytes=700,
                         shared_uplink_bps=3e6)


def test_network_spec_round_trips_and_compiles():
    """Every `NetworkSpec` field set: the reference's JSON loads in the
    port and round-trips, and `compile_plan` takes every real codec."""
    ref = japi.ExperimentSpec(schedule=japi.SchedulePolicy(kind="async"),
                              network=_full_network(japi))
    loaded = tapi.ExperimentSpec.from_json(ref.to_json())
    assert loaded.network == _full_network(tapi)
    assert loaded.to_dict() == ref.to_dict()
    for codec in tapi.NET_CODECS:
        if codec == "analytic":
            continue
        spec = tapi.ExperimentSpec(network=tapi.NetworkSpec(codec=codec))
        plan = tapi.compile_plan(spec)
        assert plan.net_codec == codec == japi.compile_plan(
            japi.ExperimentSpec(network=japi.NetworkSpec(
                codec=codec))).net_codec


def _small(m, kind, sigma, backend):
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=8, model="cnn", hw=(14, 14),
                          samples_per_node=40, n_test=128, n_cloud_test=64,
                          attack=m.AttackMix(malicious_frac=0.25)),
        schedule=m.SchedulePolicy(kind=kind),
        privacy=m.PrivacySpec(sigma=sigma),
        compression=m.CompressionSpec(sparsify_ratio=0.1),
        defense=m.DefenseSpec(detect=True),
        topology=m.Topology(backend=backend), rounds=2)


@pytest.mark.parametrize("kind,sigma,backend", [
    ("async", 0.05, "pallas"),      # ALDPFL: the paper's framework
    ("sync", 0.0, "reference")])    # SLDPFL+DGC without noise
def test_small_runs_match_reference(kind, sigma, backend):
    ref_spec = _small(japi, kind, sigma, backend)
    pj = japi.materialize(ref_spec)
    rj = japi.run(japi.compile_plan(ref_spec), population=pj)
    loss_fn, acc_fn = tapi.model_fns("cnn")
    pt = tapi.Population(
        params=convert.to_torch(pj.params), loss_fn=loss_fn, acc_fn=acc_fn,
        node_data=pj.node_data, test_data=pj.test_data,
        cloud_test=pj.cloud_test, profile=pj.profile,
        malicious_ids=pj.malicious_ids)
    port_spec = tapi.ExperimentSpec.from_json(ref_spec.to_json())
    rt = tapi.run(tapi.compile_plan(port_spec), population=pt, device="cpu")
    assert len(rj.records) == len(rt.records) == 2
    for a, b in zip(rj.records, rt.records):
        assert (a.t, a.version, a.comm_bytes, a.n_rejected) == \
            (b.t, b.version, b.comm_bytes, b.n_rejected)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / 128
    assert rj.detections == rt.detections
    assert rj.epsilon_spent == rt.epsilon_spent
    assert rt.kappa == pytest.approx(rj.kappa, rel=1e-12)
    for a, b in zip(jax.tree.leaves(rj.final_params),
                    tree.leaves(rt.final_params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-4)
    assert rt.to_dict()["records"] == [dataclasses.asdict(r)
                                       for r in rt.records]
    assert tapi.RunReport.from_json(rt.to_json()).records == rt.records


def _zoo(m, kind, backend="pallas", attack="label_flip", defense=None,
         staleness=False, network=None):
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=8, model="cnn", hw=(14, 14),
                          samples_per_node=40, n_test=128, n_cloud_test=64,
                          attack=m.AttackMix(malicious_frac=0.25,
                                             kind=attack)),
        schedule=m.SchedulePolicy(kind=kind, staleness_adaptive=staleness),
        privacy=m.PrivacySpec(sigma=0.05),
        compression=m.CompressionSpec(sparsify_ratio=0.1),
        defense=m.DefenseSpec(detect=True, kind=defense or "percentile"),
        network=m.NetworkSpec(**(network or {})),
        topology=m.Topology(backend=backend), rounds=2)


ZOO = {
    # ALDPFL and SLDPFL on the default backend: jax.random.normal noise
    "async-reference-noise": lambda m: _zoo(m, "async", "reference"),
    "sync-reference-noise": lambda m: _zoo(m, "sync", "reference"),
    "buffered-staleness": lambda m: _zoo(m, "buffered", staleness=True),
    "async-trust-sybil": lambda m: _zoo(m, "async", attack="sybil",
                                        defense="trust_weighted"),
    "sync-trust-adaptive": lambda m: _zoo(m, "sync", attack="adaptive",
                                          defense="trust_weighted"),
    "async-ddos-shared-uplink": lambda m: _zoo(
        m, "async", attack="ddos", network=dict(
            codec="sparse_coo", latency_s=0.02, shared_uplink_bps=25e6)),
}


@pytest.fixture
def one_thread():
    """One intra-op thread for the port's side of a run: these runs are
    small, and many threads per worker only contend with the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(ZOO))
def test_small_zoo_runs_match_reference(case, one_thread):
    """The reference backend's noise, the buffered fold, the trust
    defense and the sybil, adaptive and ddos attacks, held as
    `test_small_runs_match_reference` holds the others (plus
    `RunReport.net` where a codec runs)."""
    ref_spec = ZOO[case](japi)
    pj = japi.materialize(ref_spec)
    rj = japi.run(japi.compile_plan(ref_spec), population=pj)
    loss_fn, acc_fn = tapi.model_fns("cnn")
    pt = tapi.Population(
        params=convert.to_torch(pj.params), loss_fn=loss_fn, acc_fn=acc_fn,
        node_data=pj.node_data, test_data=pj.test_data,
        cloud_test=pj.cloud_test, profile=pj.profile,
        malicious_ids=pj.malicious_ids)
    port_spec = tapi.ExperimentSpec.from_json(ref_spec.to_json())
    assert port_spec == ZOO[case](tapi)
    rt = tapi.run(tapi.compile_plan(port_spec), population=pt, device="cpu")
    assert len(rj.records) == len(rt.records) >= 2
    for a, b in zip(rj.records, rt.records):
        assert (a.t, a.version, a.comm_bytes, a.comm_time, a.n_rejected,
                a.bytes_source) == (b.t, b.version, b.comm_bytes,
                                    b.comm_time, b.n_rejected,
                                    b.bytes_source)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / 128
    assert rj.detections == rt.detections
    assert rj.epsilon_spent == rt.epsilon_spent > 0
    assert rt.kappa == pytest.approx(rj.kappa, rel=1e-12)
    assert rt.net == rj.net
    if rt.net is not None:
        assert sum(r.comm_bytes for r in rt.records) == \
            rt.net["encoded_bytes"]
    for a, b in zip(jax.tree.leaves(rj.final_params),
                    tree.leaves(rt.final_params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("mode", ["aldpfl", "sldpfl"])
def test_benchmark_specs_run_on_the_port(mode, one_thread):
    """`benchmarks.common.spec_for_mode` builds the paper's private modes
    at sigma 0.05 on the default (reference) backend; the port compiles
    and runs them (one round)."""
    from benchmarks.common import spec_for_mode

    spec = tapi.ExperimentSpec.from_json(spec_for_mode(mode,
                                                       rounds=1).to_json())
    assert spec.topology.backend == "reference" and spec.privacy.sigma > 0
    report = tapi.run(tapi.compile_plan(spec), device="cpu")
    assert len(report.records) == 1 and report.epsilon_spent > 0
    assert 0.0 <= report.final_accuracy <= 1.0


LOSSY_INDUSTRIAL = dict(codec="sparse_bitpack", bandwidth_sigma=1.0,
                        latency_s=0.02, jitter_s=0.1, loss_prob=0.2)
CONGESTED_COO = dict(codec="sparse_coo", latency_s=0.02,
                     shared_uplink_bps=25e6)


@pytest.mark.parametrize("kind,sigma,ratio,detect,network", [
    # (a) ALDPFL over the lossy_industrial link of benchmarks/net_sweep.py
    ("async", 0.05, 0.1, True, LOSSY_INDUSTRIAL),
    # (b) the FL baseline (no sparsify, no noise, no detection) over a
    # shared uplink: the wire count is K3's
    ("sync", 0.0, 1.0, False, CONGESTED_COO)])
def test_small_network_runs_match_reference(kind, sigma, ratio, detect,
                                            network):
    """Equal t, version, comm_bytes, comm_time, n_rejected, bytes_source
    and `RunReport.net`; accuracy within 1/n_test; final params within
    1e-4; the records' bytes sum to the trace's encoded bytes."""
    def build(m):
        return m.ExperimentSpec(
            fleet=m.FleetSpec(n_nodes=8, model="cnn", hw=(14, 14),
                              samples_per_node=40, n_test=128,
                              n_cloud_test=64,
                              attack=m.AttackMix(malicious_frac=0.25)),
            schedule=m.SchedulePolicy(kind=kind),
            privacy=m.PrivacySpec(sigma=sigma),
            compression=m.CompressionSpec(sparsify_ratio=ratio),
            defense=m.DefenseSpec(detect=detect),
            network=m.NetworkSpec(**network),
            topology=m.Topology(backend="pallas"), rounds=2)

    ref_spec = build(japi)
    pj = japi.materialize(ref_spec)
    rj = japi.run(japi.compile_plan(ref_spec), population=pj)
    loss_fn, acc_fn = tapi.model_fns("cnn")
    pt = tapi.Population(
        params=convert.to_torch(pj.params), loss_fn=loss_fn, acc_fn=acc_fn,
        node_data=pj.node_data, test_data=pj.test_data,
        cloud_test=pj.cloud_test, profile=pj.profile,
        malicious_ids=pj.malicious_ids)
    port_spec = tapi.ExperimentSpec.from_json(ref_spec.to_json())
    assert port_spec == build(tapi)
    rt = tapi.run(tapi.compile_plan(port_spec), population=pt, device="cpu")
    assert len(rj.records) == len(rt.records) == 2
    for a, b in zip(rj.records, rt.records):
        assert (a.t, a.version, a.comm_bytes, a.comm_time, a.n_rejected,
                a.bytes_source) == (b.t, b.version, b.comm_bytes,
                                    b.comm_time, b.n_rejected,
                                    b.bytes_source)
        assert b.bytes_source == "encoded"
        assert abs(a.accuracy - b.accuracy) <= 1.0 / 128
    assert rt.net == rj.net
    assert sum(r.comm_bytes for r in rt.records) == rt.net["encoded_bytes"]
    for a, b in zip(jax.tree.leaves(rj.final_params),
                    tree.leaves(rt.final_params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-4)
    assert tapi.RunReport.from_json(rt.to_json()).net == rt.net


def test_run_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    plan = tapi.compile_plan(tapi.ExperimentSpec(rounds=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.run(plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.materialize(plan.spec)


def test_port_imports_neither_jax_nor_the_reference():
    """A fresh interpreter imports every module of the port, the port's
    examples and `chip_smoke.py`; afterwards no `jax*` and no
    `repro`/`repro.*` module is loaded."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.fleet.async_engine' in sys.modules\n"
        "assert 'repro_torch.net.bridge' in sys.modules\n"
        "assert 'repro_torch.kernels.ops' in sys.modules\n"
        "assert 'repro_torch.sim.service' in sys.modules\n"
        "assert 'repro_torch.obs.analysis' in sys.modules\n"
        "assert 'repro_torch.checkpointing.checkpoint' in sys.modules\n"
        "assert 'repro_torch.models.moe' in sys.modules\n"
        "for m in ('optim.optimizers', 'core.fed_step', 'launch.steps', "
        "'launch.train', 'fleet.mesh', 'launch.shapes', 'launch.cost', "
        "'launch.roofline', 'launch.dryrun', 'launch.dryrun_all', "
        "'configs.paper_cnn'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "import glob, importlib.util, os\n"
        f"root = {os.path.dirname(src)!r}\n"
        "for path in sorted(glob.glob(os.path.join(root, 'examples', "
        "'torch_*.py'))) + [os.path.join(root, 'chip_smoke.py')]:\n"
        "    name = os.path.basename(path)[:-3]\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
