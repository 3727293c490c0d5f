"""Vectorized node-fleet engines of the port.

`engine.FleetEngine` runs a synchronous barrier round for a whole cohort,
`async_engine.AsyncFleetEngine` an arrival window of the paper's
asynchronous scheme (sequential or buffered fold); `stages` holds the
pipeline they share (and the adversary zoo's delta attacks), `state` the
stacked per-node state, `mesh` the node axis sharded over the ranks of a
`torch.distributed` process group, and `scenarios` the declarative
populations."""
from .async_engine import (AsyncFleetConfig, AsyncFleetEngine,  # noqa: F401
                           AsyncWindowRecord)
from .engine import (AvailabilityTrace, ClientSampler, FleetConfig,  # noqa: F401
                     FleetEngine, FleetRoundRecord, FullParticipation,
                     NodeProfile, UniformSampler)
from .mesh import FleetMesh  # noqa: F401
from .scenarios import (SCENARIOS, Scenario, build_async_engine,  # noqa: F401
                        build_engine, get_scenario)
from .stages import AttackPlan  # noqa: F401
from .state import (FleetData, FleetState, broadcast_tree,  # noqa: F401
                    chain_node_keys, chain_node_keys_masked, gather_nodes,
                    init_async_fleet_state, init_fleet_state, pad_keys,
                    pad_node_axis, parallel_node_keys)
