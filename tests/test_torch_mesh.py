"""The port's node-sharded fleet (`repro_torch.fleet.mesh`) against the
reference.

The padding helpers equal `repro.fleet.state`'s exactly, and
`FleetMesh.create` refuses to run without a process group or on a size
mismatch.  Then one gloo world of 4 ranks (spawned processes joined
through a ``file://`` store under the test's own directory, so parallel
workers never share a port) runs every sharded check once, in a
module-scoped fixture, while this process computes the references:

  * sync rounds and async windows at n = 64 and 61 (uneven: 61 % 4 != 0)
    against the JAX single-device engines and the port's unsharded ones,
    at `tests/test_fleet_shard.py`'s limits: rejections equal, accuracy
    within 2e-3, params within 1e-5 (sync) and 1e-4 (async), versions
    equal (local SGD sums in another order per block than per fleet);
  * `api.run` with ``Topology(kind="mesh", devices=4)`` for the four
    schemes against the port's single-device runs (`tests/test_api.py`'s
    mesh test: equal length, t within 1e-6, rejections equal, accuracy
    within 2e-3);
  * encoded bytes equal to the network trace on the mesh
    (`tests/test_net.py`);
  * the event stream's order (`tests/test_obs.py`), written by rank 0;
  * a world-4 kill and resume bit for bit equal to the uninterrupted run
    (`tests/test_sim.py`), its checkpoint loading in the JAX package.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.data import make_federated_image_data
from repro.models import mlp as jmlp
from repro_torch import convert, tree
from repro_torch import fleet as tfleet
from repro_torch.models import mlp as tmlp

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
RANK_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# padding helpers and refusals
# ---------------------------------------------------------------------------

def test_fleet_data_pad_to_matches_reference():
    rng = np.random.default_rng(0)
    shards = [(rng.normal(size=(k, 2, 3)).astype(np.float32),
               rng.integers(0, 10, k).astype(np.int32)) for k in (3, 5, 2)]
    ref = jfleet.FleetData.from_node_data(shards).pad_to(7)
    got = tfleet.FleetData.from_node_data(shards).pad_to(7)
    for a, b in ((ref.x, got.x), (ref.y, got.y), (ref.sizes, got.sizes)):
        b = b.numpy() if torch.is_tensor(b) else b
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    same = tfleet.FleetData.from_node_data(shards)
    assert same.pad_to(3) is same
    with pytest.raises(ValueError, match="already has"):
        same.pad_to(2)


def test_pad_node_axis_and_keys_match_reference():
    rng = np.random.default_rng(1)
    t = {"w": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    ref = jfleet.pad_node_axis(jax.tree.map(jax.numpy.asarray, t), 8)
    got = tfleet.pad_node_axis(convert.to_torch(t), 8)
    for a, b in zip(jax.tree.leaves(ref), tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError, match="leading axis"):
        tfleet.pad_node_axis(convert.to_torch(t), 2)
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    np.testing.assert_array_equal(np.asarray(jfleet.pad_keys(ks, 6)),
                                  tfleet.pad_keys(np.asarray(ks), 6))


def test_fleet_mesh_refuses_without_a_group_or_on_a_size_mismatch(tmp_path):
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        tfleet.FleetMesh.create()
    with pytest.raises(ValueError, match="init_process_group"):
        tfleet.FleetMesh.create(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="2 devices requested"):
            tfleet.FleetMesh.create(2)
        mesh = tfleet.FleetMesh.create()
        assert (mesh.n_devices, mesh.rank, mesh.backend) == (1, 0, "gloo")
        assert mesh.padded(7) == 7 and mesh.device("cpu").type == "cpu"
        with pytest.raises(ValueError, match="nccl"):
            mesh.device("cuda")
        rank1 = tfleet.FleetMesh(4, 1, "gloo")
        assert rank1.padded(61) == 64 and rank1.bounds(64) == (16, 32)
        t = {"w": torch.arange(16.0).reshape(8, 2)}
        assert rank1.put_replicated(t) is t
        np.testing.assert_array_equal(rank1.put_nodes(t)["w"].numpy(),
                                      [[4.0, 5.0], [6.0, 7.0]])
        with pytest.raises(ValueError, match="do not split"):
            rank1.bounds(61)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the gloo world of 4
# ---------------------------------------------------------------------------

ENGINE_SIZES = (64, 61)          # even and uneven against 4 ranks
SCHEMES = {"sfl": ("sync", 0.0), "afl": ("async", 0.0),
           "sldpfl": ("sync", 0.05), "aldpfl": ("async", 0.05)}


def _population(n):
    node_data, test, cloud, _ = make_federated_image_data(
        0, n_nodes=n, n_malicious=n // 5, n_train=40 * n, n_test=256,
        n_cloud_test=128, hw=(8, 8))
    profile = jfleet.NodeProfile.lognormal(n, 1.0, 0.5, 12.5e6, seed=0)
    params = jmlp.init_mlp(jax.random.PRNGKey(0), 64)
    return params, node_data, test, cloud, profile


def _engine_cfgs(m, n):
    sync = m.FleetConfig(local_steps=4, batch_size=16, lr=0.1, detect=True,
                         sigma=0.05, sparsify_ratio=0.5,
                         key_mode="sequential", seed=0)
    asyn = m.AsyncFleetConfig(local_steps=4, batch_size=16, lr=0.1,
                              detect=True, sigma=0.05, sparsify_ratio=0.5,
                              key_mode="sequential", seed=0,
                              detect_window=max(n, 4))
    return sync, asyn


def _scheme_spec(m, kind, sigma, topology):
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=8, samples_per_node=40, n_test=128,
                          n_cloud_test=64, hw=(8, 8),
                          attack=m.AttackMix(malicious_frac=0.25),
                          profile=m.NodeHeterogeneity(heterogeneity=0.5)),
        schedule=m.SchedulePolicy(kind=kind),
        privacy=m.PrivacySpec(sigma=sigma),
        compression=m.CompressionSpec(sparsify_ratio=0.5),
        defense=m.DefenseSpec(detect=True),
        topology=topology,
        train=m.TrainSpec(local_steps=3, batch_size=16, lr=0.1),
        rounds=2, seed=0)


def _net_spec(m, kind, topology):
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=5, samples_per_node=20, n_test=32,
                          n_cloud_test=16, hw=(8, 8),
                          profile=m.NodeHeterogeneity(heterogeneity=0.8)),
        schedule=m.SchedulePolicy(kind=kind),
        compression=m.CompressionSpec(sparsify_ratio=0.5),
        network=m.NetworkSpec(codec="sparse_bitpack", bandwidth_sigma=1.0,
                              loss_prob=0.2, jitter_s=0.1),
        topology=topology,
        train=m.TrainSpec(local_steps=2, batch_size=8, lr=0.1),
        rounds=2, seed=0)


def _obs_spec(m, events_jsonl):
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=8, samples_per_node=20, n_test=32,
                          n_cloud_test=16, hw=(8, 8),
                          attack=m.AttackMix(malicious_frac=0.25),
                          profile=m.NodeHeterogeneity(heterogeneity=0.8)),
        schedule=m.SchedulePolicy(kind="async"),
        defense=m.DefenseSpec(detect=True),
        topology=m.Topology(kind="mesh", devices=WORLD),
        obs=m.ObsSpec(enabled=True, events_jsonl=events_jsonl),
        train=m.TrainSpec(local_steps=2, batch_size=8, lr=0.1),
        rounds=2, seed=0)


def _resume_spec(m, kind):
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=6, samples_per_node=20, n_test=32,
                          n_cloud_test=16, hw=(8, 8)),
        schedule=m.SchedulePolicy(kind=kind),
        privacy=m.PrivacySpec(sigma=0.05),
        defense=m.DefenseSpec(detect=True),
        topology=m.Topology(kind="mesh", devices=WORLD),
        train=m.TrainSpec(local_steps=2, batch_size=8, lr=0.1),
        rounds=3, seed=0)


def _records(report):
    return [(r.t, r.version, r.accuracy, r.comm_bytes, r.comp_time,
             r.comm_time, r.n_rejected) for r in report.records]


def _host(t):
    return [x.detach().cpu().numpy() for x in tree.leaves(t)]


# What every rank runs.  It imports the port only (no JAX); rank 0 writes
# the results.  `spec_fns` carries the spec builders above by source, so
# both sides build the same specs.
RANK_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=180))
    from repro_torch import api, tree
    from repro_torch import fleet as tfleet
    from repro_torch.models import mlp as tmlp
    from repro_torch.sim import SimService
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    ns = {"WORLD": world}
    exec(inp["spec_fns"], ns)

    def host(t):
        return [x.detach().cpu().numpy() for x in tree.leaves(t)]

    def records(report):
        return [(r.t, r.version, r.accuracy, r.comm_bytes, r.comp_time,
                 r.comm_time, r.n_rejected) for r in report.records]

    out = {}
    mesh = tfleet.FleetMesh.create(world)
    for n, (params, node_data, test, cloud, profile) in inp["engines"]:
        sync, asyn = ns["_engine_cfgs"](tfleet, n)
        args = (params, tmlp.mlp_loss, tmlp.mlp_accuracy, node_data, test,
                cloud)
        eng = tfleet.FleetEngine(*args, sync, profile=profile, mesh=mesh,
                                 device="cpu")
        hist = eng.run(3)
        out[f"sync{n}"] = ([(r.accuracy, r.n_rejected) for r in hist],
                           host(eng.params))
        eng = tfleet.AsyncFleetEngine(*args, asyn, profile=profile,
                                      mesh=mesh, device="cpu")
        eng.run_arrivals(2 * n)
        out[f"async{n}"] = (int(eng.state.version), host(eng.params))

    for mode, (kind, sigma) in ns["SCHEMES"].items():
        spec = ns["_scheme_spec"](api, kind, sigma,
                                  api.Topology(kind="mesh", devices=world))
        pop = api.Population(**inp["scheme_pop"])
        rep = api.run(api.compile_plan(spec), population=pop, device="cpu")
        out["scheme_" + mode] = (rep.engine, records(rep),
                                 host(rep.final_params))

    for kind in ("sync", "async"):
        spec = ns["_net_spec"](api, kind,
                               api.Topology(kind="mesh", devices=world))
        rep = api.run(api.compile_plan(spec), device="cpu")
        out["net_" + kind] = {
            "engine": rep.engine,
            "sum_bytes": sum(r.comm_bytes for r in rep.records),
            "trace_bytes": rep.net["encoded_bytes"],
            "n_uploads": rep.net["n_uploads"],
            "sources": sorted({r.bytes_source for r in rep.records})}

    spec = ns["_obs_spec"](api, os.path.join(tmp, "events.jsonl"))
    rep = api.run(api.compile_plan(spec), device="cpu")
    out["obs"] = (rep.engine, sum(r.n_rejected for r in rep.records))

    for kind in ("sync", "async"):
        spec = ns["_resume_spec"](api, kind)
        base = api.run(api.compile_plan(spec), device="cpu")
        svc = SimService(api.compile_plan(spec), device="cpu")
        svc.run(max_records=1)
        path = svc.checkpoint(os.path.join(tmp, "ck_" + kind))
        rep = SimService.resume(path, device="cpu").run()
        out["resume_" + kind] = (
            rep.engine, records(rep) == records(base),
            all(np.array_equal(a, b) for a, b in
                zip(host(rep.final_params), host(base.final_params))),
            path, records(base))
    dist.barrier()
    if rank == 0:
        with open(os.path.join(tmp, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()
""")


def _spec_fns_source() -> str:
    import inspect
    return "\n".join(
        [f"SCHEMES = {SCHEMES!r}"]
        + [textwrap.dedent(inspect.getsource(f)) for f in
           (_engine_cfgs, _scheme_spec, _net_spec, _obs_spec, _resume_spec)])


def _jax_engines(n):
    params, node_data, test, cloud, profile = _population(n)
    sync, asyn = _engine_cfgs(jfleet, n)
    args = (params, jmlp.mlp_loss, jmlp.mlp_accuracy, node_data, test, cloud)
    eng = jfleet.FleetEngine(*args, sync, profile=profile)
    hist = eng.run(3)
    aeng = jfleet.AsyncFleetEngine(*args, asyn, profile=profile)
    aeng.run_arrivals(2 * n)
    return ([(r.accuracy, r.n_rejected) for r in hist],
            [np.asarray(x) for x in jax.tree.leaves(eng.params)],
            int(aeng.state.version),
            [np.asarray(x) for x in jax.tree.leaves(aeng.params)])


def _port_engines(n, inputs):
    params, node_data, test, cloud, profile = inputs
    sync, asyn = _engine_cfgs(tfleet, n)
    args = (params, tmlp.mlp_loss, tmlp.mlp_accuracy, node_data, test, cloud)
    eng = tfleet.FleetEngine(*args, sync, profile=profile, device="cpu")
    hist = eng.run(3)
    aeng = tfleet.AsyncFleetEngine(*args, asyn, profile=profile,
                                   device="cpu")
    aeng.run_arrivals(2 * n)
    return ([(r.accuracy, r.n_rejected) for r in hist], _host(eng.params),
            int(aeng.state.version), _host(aeng.params))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 4 ranks, compute the references here meanwhile, and
    collect rank 0's results (each rank waited on with a timeout)."""
    from repro_torch import api as tapi

    tmp = str(tmp_path_factory.mktemp("mesh_world"))
    engines, jax_ref = [], {}
    for n in ENGINE_SIZES:
        params, node_data, test, cloud, profile = _population(n)
        engines.append((n, (convert.to_torch(params), node_data, test, cloud,
                            profile)))
    spec = _scheme_spec(tapi, "sync", 0.0, tapi.Topology())
    pop = tapi.materialize(spec, device="cpu")
    scheme_pop = dict(params=pop.params, loss_fn=pop.loss_fn,
                      acc_fn=pop.acc_fn, node_data=pop.node_data,
                      test_data=pop.test_data, cloud_test=pop.cloud_test,
                      profile=pop.profile, malicious_ids=pop.malicious_ids)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"engines": engines, "scheme_pop": scheme_pop,
                     "spec_fns": _spec_fns_source()}, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(WORLD), store, tmp],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for n, inputs in engines:
                jax_ref[n] = _jax_engines(n)
                jax_ref[f"port{n}"] = _port_engines(n, inputs)
            single = {}
            for mode, (kind, sigma) in SCHEMES.items():
                rep = tapi.run(tapi.compile_plan(_scheme_spec(
                    tapi, kind, sigma, tapi.Topology())),
                    population=tapi.Population(**scheme_pop), device="cpu")
                single[mode] = (_records(rep), _host(rep.final_params))
        finally:
            torch.set_num_threads(n_threads)
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
    return {"out": out, "jax": jax_ref, "single": single, "tmp": tmp}


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a, b))


ENGINE_CASES = [(kind, n, ref) for kind in ("sync", "async")
                for n in ENGINE_SIZES for ref in ("jax", "port")]


@pytest.mark.parametrize("kind,n,ref", ENGINE_CASES)
def test_sharded_engines_match_single_device(world, kind, n, ref):
    """World-4 sync rounds and async windows against the JAX and the port's
    single-device engines at `tests/test_fleet_shard.py`'s limits."""
    want = world["jax"][n if ref == "jax" else f"port{n}"]
    got = world["out"][f"{kind}{n}"]
    if kind == "sync":
        recs, params = got
        assert [r[1] for r in recs] == [r[1] for r in want[0]]
        assert max(abs(a[0] - b[0]) for a, b in zip(recs, want[0])) < 2e-3
        assert _max_diff(params, want[1]) < 1e-5
    else:
        version, params = got
        assert version == want[2]
        assert _max_diff(params, want[3]) < 1e-4


@pytest.mark.parametrize("mode", sorted(SCHEMES))
def test_api_mesh_runs_match_single_device(world, mode):
    engine, recs, params = world["out"]["scheme_" + mode]
    want, want_params = world["single"][mode]
    assert engine == "fleet-mesh"
    assert len(recs) == len(want) == 2
    for a, b in zip(recs, want):
        assert abs(a[0] - b[0]) < 1e-6            # t
        assert a[6] == b[6]                       # n_rejected
        assert abs(a[2] - b[2]) < 2e-3            # accuracy
    assert _max_diff(params, want_params) < 1e-4


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_mesh_network_bytes_equal_the_trace(world, kind):
    got = world["out"]["net_" + kind]
    assert got["engine"] == "fleet-mesh"
    assert got["sum_bytes"] == got["trace_bytes"] > 0
    assert got["n_uploads"] == 10          # 5 nodes x 2 rounds
    assert got["sources"] == ["encoded"]


def test_mesh_event_stream_keeps_its_order(world):
    from repro_torch.obs import read_jsonl

    engine, n_rejected = world["out"]["obs"]
    assert engine == "fleet-mesh"
    rows = read_jsonl(os.path.join(world["tmp"], "events.jsonl"))
    assert rows[0]["engine"] == "fleet-mesh"
    evs = [r for r in rows if r.get("kind") in ("span", "instant", "counter")]
    seqs = [e["seq"] for e in evs]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    windows = [e["tags"]["window"] for e in evs
               if e["kind"] == "span" and e["name"] == "window"]
    assert windows == sorted(windows) and len(windows) > 0
    verdicts = [e for e in evs if e["name"] == "detect.verdict"]
    arrivals = {(e["tags"]["node"], e["tags"]["window"]): e["seq"]
                for e in evs if e["name"] == "arrival"}
    assert verdicts
    for v in verdicts:
        key = (v["tags"]["node"], v["tags"]["window"])
        assert key in arrivals and arrivals[key] < v["seq"]
    assert sum(v["tags"]["rejected"] for v in verdicts) == n_rejected


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_mesh_kill_and_resume_is_bitwise(world, kind):
    """A world-4 run checkpointed after one record and resumed ends on the
    uninterrupted run's records and params bit for bit; the checkpoint
    (written by rank 0, layout-free) loads in the JAX package against a
    single-device service's template."""
    from repro import api as japi
    from repro.checkpointing import load_checkpoint, read_manifest
    from repro.sim import SimService as JSimService

    engine, same_records, same_params, path, _ = \
        world["out"]["resume_" + kind]
    assert engine == "fleet-mesh" and same_records and same_params
    spec = dataclasses.replace(_resume_spec(japi, kind),
                               topology=japi.Topology())
    like, _ = JSimService(japi.compile_plan(spec)).stepper.export_state()
    got, step = load_checkpoint(path, {"stepper": like,
                                       "membership": np.ones(6, bool)})
    assert step == 1 and read_manifest(path)["extra"]["records_done"] == 1
    for a, b in zip(jax.tree.leaves(got["stepper"]), jax.tree.leaves(like)):
        assert np.shape(a) == np.shape(b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
