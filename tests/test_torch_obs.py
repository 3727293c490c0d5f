"""The port's observability layer against `repro.obs`.

The stdlib modules on the same events give equal results: `TraceEvent`
dicts and JSONL files cross between the packages, metrics snapshots and
Prometheus text, the Chrome trace (but its producer name), `read_jsonl`'s
torn-tail rules, a `FleetAnalytics` snapshot and `HealthMonitor` alerts
over a reference run's events file, the postmortem and run-diff text, and
the command line's output and exit codes (`tools/obs_report.py`).

Small traced runs (sync and async, pallas and reference backends, over
the lossy link, health probes live) give the same event stream in both
packages from one population: the same (kind, name, tags) sequence and
virtual times, the ``accuracy`` and ``threshold`` tags within
1/n_cloud_test (one cloud test sample: local SGD sums in another order in
XLA than in PyTorch), every verdict equal.  In the port a traced run,
with and without stage timings, is bit for bit the untraced run."""
import contextlib
import importlib.util
import io
import itertools
import json
import os

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import obs as jobs
from repro.obs import report as jreport
from repro_torch import api as tapi
from repro_torch import convert, tree
from repro_torch import obs as tobs
from repro_torch.obs import report as treport

N_CLOUD_TEST = 64
LOSSY = dict(codec="sparse_bitpack", bandwidth_sigma=1.0, latency_s=0.02,
             jitter_s=0.1, loss_prob=0.2)


def _tracer(mod, sink):
    return mod.Tracer(sinks=[sink], clock=itertools.count(0.5).__next__)


def _emit(mod):
    """One fixed event sequence through a package's `Tracer`: a span with
    virtual times and late tags, instants, counters, metrics."""
    sink = mod.MemorySink()
    tr = _tracer(mod, sink)
    with tr.span("window", virt_t=1.0, window=0) as sp:
        tr.instant("arrival", virt_t=1.25, node=3, window=0, arrived=True)
        tr.instant("detect.verdict", virt_t=1.25, node=3, window=0,
                   accuracy=0.5, threshold=0.25, rejected=False,
                   detect=True)
        tr.counter("net.bytes", 1234, virt_t=1.5, node=3)
        sp.set(n_processed=1)
        sp.set_virtual(virt_end=2.0)
    tr.instant("sim.event", kind="attack", at_round=1, payload={"a": 1})
    tr.counter("window.size", 7)
    m = tr.metrics
    m.counter("c").inc(3)
    m.gauge("g.x").set(-1.5)
    h = m.histogram("h", mod.SECONDS_EDGES)
    for v in (1e-5, 0.02, 0.02, 7.0, 5000.0):
        h.observe(v)
    return sink.events, tr


def test_trace_events_and_jsonl_cross_between_packages(tmp_path):
    ref, _ = _emit(jobs)
    port, _ = _emit(tobs)
    assert [e.to_dict() for e in port] == [e.to_dict() for e in ref]
    for e in ref:
        assert tobs.TraceEvent.from_dict(e.to_dict()).to_dict() == \
            e.to_dict()
    for writer, reader in ((jobs, tobs), (tobs, jobs)):
        path = str(tmp_path / f"{writer.__name__}.jsonl")
        sink = writer.JsonlSink(path, header={"mode": "async"})
        for e in ref:
            sink.emit(e)
        sink.close()
        got = reader.read_events(path)
        assert [e.to_dict() for e in got] == [e.to_dict() for e in ref]
        assert reader.read_jsonl(path)[0] == {
            "kind": "header", "obs_schema": 1, "mode": "async"}
    assert tobs.OBS_SCHEMA_VERSION == jobs.OBS_SCHEMA_VERSION
    with pytest.raises(ValueError, match="not in"):
        tobs.TraceEvent.from_dict({"kind": "bogus", "name": "x",
                                   "wall_t": 0.0})


def test_metrics_snapshot_prom_text_and_errors_match():
    _, tj = _emit(jobs)
    _, tt = _emit(tobs)
    assert tt.metrics.snapshot() == tj.metrics.snapshot()
    assert tt.metrics.to_prom_text() == tj.metrics.to_prom_text()
    hj, ht = tj.metrics.histogram("h", jobs.SECONDS_EDGES), \
        tt.metrics.histogram("h", tobs.SECONDS_EDGES)
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert ht.quantile(q) == hj.quantile(q)
    for mod, tr in ((jobs, tj), (tobs, tt)):
        with pytest.raises(ValueError, match="monotone"):
            tr.metrics.counter("c").inc(-1)
        with pytest.raises(ValueError, match="already registered"):
            tr.metrics.histogram("h", (1.0, 2.0))
        with pytest.raises(TypeError, match="is a Counter"):
            tr.metrics.gauge("c")


def test_chrome_trace_matches_but_the_producer():
    ref, _ = _emit(jobs)
    port, _ = _emit(tobs)
    cj, ct = jobs.chrome_trace(ref), tobs.chrome_trace(port)
    assert ct["otherData"].pop("producer") == "repro_torch.obs"
    cj["otherData"].pop("producer")
    assert ct == cj
    json.dumps(ct)


TORN = {
    "clean": ('{"kind":"header"}\n{"a":1}\n', True),
    "torn-final-strict": ('{"kind":"header"}\n{"a":1}\n{"b":', True),
    "torn-final-lenient": ('{"kind":"header"}\n{"a":1}\n{"b":', False),
    "torn-middle": ('{"kind":"header"}\n{"a":\n{"b":2}\n', False),
    "no-trailing-newline": ('{"kind":"header"}\n{"a":1}', True),
}


@pytest.mark.parametrize("case", sorted(TORN))
def test_read_jsonl_torn_tail_rules_match(tmp_path, case):
    text, strict = TORN[case]
    path = str(tmp_path / "s.jsonl")
    with open(path, "w") as f:
        f.write(text)
    out = []
    for mod in (jobs, tobs):
        try:
            out.append(mod.read_jsonl(path, strict=strict))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# small traced runs in both packages, one population
# ---------------------------------------------------------------------------

RUNS = [("sync", "pallas"), ("sync", "reference"), ("async", "pallas"),
        ("async", "reference")]


def _traced(m, kind, backend, path):
    health = m.HealthSpec(
        straggler_factor=1.5 if kind == "async" else 0.0,
        bytes_per_record_budget=60000.0, reject_rate_threshold=0.2,
        reject_rate_window=8, warmup_records=1)
    return m.ExperimentSpec(
        fleet=m.FleetSpec(n_nodes=8, model="mlp", hw=(8, 8),
                          samples_per_node=40, n_test=128,
                          n_cloud_test=N_CLOUD_TEST,
                          profile=m.NodeHeterogeneity(straggler_frac=0.25),
                          attack=m.AttackMix(malicious_frac=0.25)),
        schedule=m.SchedulePolicy(kind=kind),
        privacy=m.PrivacySpec(sigma=0.05),
        compression=m.CompressionSpec(sparsify_ratio=0.1),
        defense=m.DefenseSpec(detect=True),
        network=m.NetworkSpec(**LOSSY),
        obs=m.ObsSpec(enabled=True, events_jsonl=path, health=health),
        topology=m.Topology(backend=backend), rounds=3)


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """Each of `RUNS` traced in the reference and in the port (from the
    reference's population): case -> (events path of each, reports)."""
    d = tmp_path_factory.mktemp("traced")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for kind, backend in RUNS:
            pj_path = str(d / f"ref-{kind}-{backend}.jsonl")
            pt_path = str(d / f"port-{kind}-{backend}.jsonl")
            ref_spec = _traced(japi, kind, backend, pj_path)
            pj = japi.materialize(ref_spec)
            rj = japi.run(japi.compile_plan(ref_spec), population=pj)
            loss_fn, acc_fn = tapi.model_fns("mlp")
            pt = tapi.Population(
                params=convert.to_torch(pj.params), loss_fn=loss_fn,
                acc_fn=acc_fn, node_data=pj.node_data,
                test_data=pj.test_data, cloud_test=pj.cloud_test,
                profile=pj.profile, malicious_ids=pj.malicious_ids)
            port_spec = tapi.ExperimentSpec.from_json(ref_spec.to_json())
            port_spec = _replace_events(port_spec, pt_path)
            rt = tapi.run(tapi.compile_plan(port_spec), population=pt,
                          device="cpu")
            out[(kind, backend)] = (pj_path, pt_path, rj, rt)
    finally:
        torch.set_num_threads(n)
    return out


def _replace_events(spec, path):
    import dataclasses
    return dataclasses.replace(spec, obs=dataclasses.replace(
        spec.obs, events_jsonl=path))


LOOSE = ("accuracy", "threshold")


@pytest.mark.parametrize("kind,backend", RUNS)
def test_traced_runs_match_the_reference(traced_runs, kind, backend):
    pj_path, pt_path, rj, rt = traced_runs[(kind, backend)]
    ej, et = jobs.read_events(pj_path), tobs.read_events(pt_path)
    assert len(et) == len(ej) > 0
    names = {e.name for e in et}
    assert {"fleet.population", "net.upload", "detect.verdict"} <= names
    assert ("arrival" in names) == (kind == "async")
    for a, b in zip(ej, et):
        ta = {k: v for k, v in a.tags.items() if k not in LOOSE}
        tb = {k: v for k, v in b.tags.items() if k not in LOOSE}
        assert (b.kind, b.name, tb, b.virt_t, b.virt_dur, b.value) == \
            (a.kind, a.name, ta, a.virt_t, a.virt_dur, a.value)
        for k in LOOSE:
            assert abs(a.tags.get(k, 0.0) - b.tags.get(k, 0.0)) <= \
                1.0 / N_CLOUD_TEST
    mj = [r for r in jobs.read_jsonl(pj_path) if r["kind"] == "metrics"]
    mt = [r for r in tobs.read_jsonl(pt_path) if r["kind"] == "metrics"]
    mj, mt = mj[0]["metrics"], mt[0]["metrics"]
    acc_j, acc_t = (x.pop("model.accuracy", None) for x in (mj, mt))
    assert mt == mj
    assert (acc_t is None) == (acc_j is None)
    assert [(r.t, r.n_rejected, r.comm_bytes) for r in rt.records] == \
        [(r.t, r.n_rejected, r.comm_bytes) for r in rj.records]


def test_analytics_and_health_monitor_over_a_reference_events_file(
        traced_runs):
    """A reference run's events file, read by each package: the same
    `FleetAnalytics` snapshot, and a fresh `HealthMonitor` polled at each
    window's end raises the same alerts and incidents."""
    path = traced_runs[("async", "pallas")][0]
    snaps, raised = [], []
    for mod in (jobs, tobs):
        events = mod.read_events(path)
        snaps.append(mod.FleetAnalytics.from_events(events).snapshot())
        sink = mod.MemorySink()
        tr = mod.Tracer(sinks=[sink], clock=lambda: 0.0)
        an = mod.FleetAnalytics(n_nodes=8)
        mon = mod.HealthMonitor(
            mod.HealthSpec(straggler_factor=1.5, reject_rate_threshold=0.2,
                           reject_rate_window=8, warmup_records=1),
            an, tr, n_nodes=8)
        windows = 0
        for ev in events:
            if ev.name.startswith("health."):
                continue
            an.emit(ev)
            if ev.name == "window":
                windows += 1
                mon.evaluate(ev.virt_t + ev.virt_dur, windows)
        mon.finalize(an.t_max, windows)
        raised.append([e.to_dict() for e in sink.events])
    assert snaps[1] == snaps[0]
    assert raised[1] == raised[0]
    assert any(e["name"] == "health.alert" for e in raised[0])


def test_postmortem_and_run_diff_text_match(traced_runs):
    a = traced_runs[("async", "pallas")][0]
    b = traced_runs[("sync", "pallas")][0]
    rows_a, rows_b = jobs.read_jsonl(a), jobs.read_jsonl(b)
    assert treport.postmortem_md(rows_a, top_k=3) == \
        jreport.postmortem_md(rows_a, top_k=3)
    assert tobs.postmortem_md is treport.postmortem_md
    for x, y in ((rows_a, rows_b), (rows_b, rows_a)):
        assert treport.run_diff_md(x, y, "A", "B", rtol=0.01) == \
            jreport.run_diff_md(x, y, "A", "B", rtol=0.01)


def _reference_cli():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "obs_report.py")
    spec = importlib.util.spec_from_file_location("obs_report_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _call(main, argv):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue(), err.getvalue()


def test_command_line_output_and_exit_codes_match(traced_runs, tmp_path):
    a = traced_runs[("async", "pallas")][0]
    b = traced_runs[("sync", "reference")][0]
    torn = str(tmp_path / "torn.jsonl")
    with open(a) as f, open(torn, "w") as g:
        g.write(f.read() + '{"kind": "inst')
    cases = [["postmortem", a, "--top-k", "3"],
             ["diff", a, b, "--fail-on-regression"],
             ["diff", b, a, "--fail-on-regression", "--rtol", "0.01"],
             ["diff", a, a, "--fail-on-regression"],
             ["postmortem", torn],
             ["postmortem", torn, "--tolerate-torn"]]
    ref_main = _reference_cli()
    codes = []
    for argv in cases:
        want, got = _call(ref_main, argv), _call(treport.main, argv)
        assert got == want, argv
        codes.append(got[0])
    assert 1 in codes and 0 in codes
    assert isinstance(codes[4], str) and "truncated" in codes[4]


# ---------------------------------------------------------------------------
# the port alone: tracing leaves a run bit for bit as it was
# ---------------------------------------------------------------------------

def _small(kind, obs):
    return tapi.ExperimentSpec(
        fleet=tapi.FleetSpec(n_nodes=8, model="mlp", hw=(8, 8),
                             samples_per_node=40, n_test=64,
                             n_cloud_test=64,
                             attack=tapi.AttackMix(malicious_frac=0.25)),
        schedule=tapi.SchedulePolicy(kind=kind),
        privacy=tapi.PrivacySpec(sigma=0.05),
        compression=tapi.CompressionSpec(sparsify_ratio=0.1),
        defense=tapi.DefenseSpec(detect=True),
        network=tapi.NetworkSpec(**LOSSY), obs=obs,
        topology=tapi.Topology(backend="pallas"), rounds=2)


@pytest.mark.parametrize("kind", ["sync", "async", "buffered"])
def test_tracing_leaves_the_run_bit_identical(kind, tmp_path):
    base = tapi.run(tapi.compile_plan(_small(kind, tapi.ObsSpec())),
                    device="cpu")
    for staged in (False, True):
        obs = tapi.ObsSpec(
            enabled=True, stage_timings=staged,
            events_jsonl=str(tmp_path / f"e{staged}.jsonl"),
            records_jsonl=str(tmp_path / f"r{staged}.jsonl"),
            chrome_trace=str(tmp_path / f"c{staged}.json"),
            health=tapi.HealthSpec(reject_rate_threshold=0.3))
        rep = tapi.run(tapi.compile_plan(_small(kind, obs)), device="cpu")
        assert (rep.records, rep.detections, rep.net, rep.epsilon_spent) \
            == (base.records, base.detections, base.net, base.epsilon_spent)
        for a, b in zip(tree.leaves(base.final_params),
                        tree.leaves(rep.final_params)):
            assert torch.equal(a, b)
        events = tobs.read_events(obs.events_jsonl)
        stages = {e.name for e in events if e.name.startswith("stage.")}
        assert bool(stages) == staged
        replayed = tapi.replay_records(obs.records_jsonl)
        assert replayed.records == rep.records
        assert replayed.detections == rep.detections
        with open(obs.chrome_trace) as f:
            assert json.load(f)["traceEvents"]
        an = tobs.FleetAnalytics.from_events(events)
        assert an.n_rejected == sum(r.n_rejected for r in rep.records)
        assert an.total_upload_bytes == sum(r.comm_bytes
                                            for r in rep.records)


def test_fence_timed_stage_and_bench_kernel_on_the_cpu():
    x = {"a": (torch.ones(2), [torch.zeros(1), 3.0]), "b": "host"}
    assert tobs.fence(x) is x
    sink = tobs.MemorySink()
    for enabled, staged, spans in ((False, True, 0), (True, False, 0),
                                   (True, True, 1)):
        tr = tobs.Tracer(sinks=[sink], enabled=enabled,
                         stage_timings=staged)
        before = len(sink.events)
        with tobs.timed_stage(tr, "window.device", window=3) as st:
            assert st.fence(x) is x
        assert len(sink.events) - before == spans
    assert sink.events[-1].name == "stage.window.device"
    assert sink.events[-1].tags == {"window": 3}
    tr = tobs.Tracer(sinks=[sink])
    us = tobs.bench_kernel("add", torch.add, torch.ones(8), torch.ones(8),
                           iters=2, tracer=tr)
    assert us > 0 and sink.events[-1].name == "kernel.add"
    assert sink.events[-1].value == us
    assert tr.metrics.snapshot()["kernel.us_per_call"]["count"] == 1
    assert np.isfinite(us)
