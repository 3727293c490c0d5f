"""Declarative experiment API of the port: spec -> plan -> run.

The same surface as `repro.api`, on PyTorch:

    from repro_torch import api

    spec = api.ExperimentSpec(
        fleet=api.FleetSpec(n_nodes=50, model="cnn", hw=(28, 28),
                            attack=api.AttackMix(malicious_frac=0.3)),
        schedule=api.SchedulePolicy(kind="async"),
        privacy=api.PrivacySpec(sigma=0.05),
        compression=api.CompressionSpec(sparsify_ratio=0.1),
        defense=api.DefenseSpec(detect=True),
        topology=api.Topology(backend="pallas"), rounds=2)
    report = api.run(api.compile_plan(spec))          # on the GPU
    report = api.run(api.compile_plan(spec), device="cpu")  # no card
"""
from ..obs.health import HealthSpec  # noqa: F401  (the ObsSpec.health axis)
from .plan import (BACKENDS, NET_CODECS, SCHEDULE_KINDS,  # noqa: F401
                   TOPOLOGY_KINDS, ExperimentPlan, SpecError, compile_plan)
from .population import (Population, default_sampler,  # noqa: F401
                         materialize, model_fns)
from .report import (RoundRecord, RunReport,  # noqa: F401
                     append_json_records, detection_log, load_json_records,
                     replay_records)
from .run import (RunState, execute, init_state, make_engine,  # noqa: F401
                  make_stepper, run)
from .spec import (ACCEPTED_SCHEMA_VERSIONS, SCHEMA_VERSION,  # noqa: F401
                   AttackMix, CompressionSpec, DefenseSpec, ExperimentSpec,
                   FleetSpec, NetworkSpec, NodeHeterogeneity, ObsSpec,
                   PrivacySpec, SchedulePolicy, SimEvent, SimSpec, Topology,
                   TrafficTrace, TrainSpec, apply_sim_event)
from .window import (AutoWindow, FixedWindow,  # noqa: F401
                     TargetArrivalsWindow, WindowPolicy,
                     window_policy_from_dict)
