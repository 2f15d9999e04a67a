"""Serving layer of the port: request/traffic modelling, the
run-to-completion server, the iteration-level continuous-batching scheduler
(live engine + simulation backends behind one protocol), slot/block-pool
bookkeeping, the copy-on-write prefix cache, the telemetry hub, and latency
metrics."""
from repro_torch.serving.acceptance import GeometricAcceptance, match_prob
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import BatchRecord, Request
from repro_torch.serving.scheduler import (AdmissionPolicy,
                                           ContinuousEngineBackend,
                                           ContinuousScheduler, FCFSBacklog,
                                           HostShardQueue, ImmediateAdmit,
                                           PrefillBudgetAdmit, SimStepBackend,
                                           controller_s_cap, replay_sources,
                                           serve_continuous_live)
from repro_torch.serving.server import (EngineBackend, ServeResult, SimBackend,
                                        serve, serve_continuous)
from repro_torch.serving.slots import (BlockPool, BlockPoolExhausted,
                                       PagedKVTables, SlotPool)
from repro_torch.serving.telemetry import PHASES, Telemetry
from repro_torch.serving.traffic import (TrafficPhase, alternating_traffic,
                                         make_requests, uniform_traffic)
