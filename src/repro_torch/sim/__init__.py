"""repro_torch.sim — the always-on simulation service (port of `repro.sim`).

Checkpoint/resume, time-varying traffic traces, and mid-run spec
mutation over the record steppers `api.run` executes in batch.  Declare
the behaviour on ``ExperimentSpec.sim`` (an `api.SimSpec`) and `api.run`
routes through `SimService` automatically; or drive a service directly
for kill/resume control.
"""
from .service import SimService  # noqa: F401
from .traffic import DynamicSampler, modulation, region_mask  # noqa: F401
