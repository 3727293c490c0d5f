"""Vectorized node-fleet engines of the port (single device).

`engine.FleetEngine` runs a synchronous barrier round for a whole cohort,
`async_engine.AsyncFleetEngine` an arrival window of the paper's
asynchronous scheme; `stages` holds the pipeline they share and `state`
the stacked per-node state."""
from .async_engine import (AsyncFleetConfig, AsyncFleetEngine,  # noqa: F401
                           AsyncWindowRecord)
from .engine import (AvailabilityTrace, ClientSampler, FleetConfig,  # noqa: F401
                     FleetEngine, FleetRoundRecord, FullParticipation,
                     NodeProfile, UniformSampler)
from .state import (FleetData, FleetState, broadcast_tree,  # noqa: F401
                    chain_node_keys, chain_node_keys_masked, gather_nodes,
                    init_async_fleet_state, init_fleet_state,
                    parallel_node_keys)
