"""Serving layer of the port: request/traffic modelling, the
run-to-completion server with its live-engine and simulated backends, and
latency metrics.  The iteration-level scheduler is not ported yet."""
from repro_torch.serving.acceptance import GeometricAcceptance, match_prob
from repro_torch.serving.request import BatchRecord, Request
from repro_torch.serving.server import EngineBackend, ServeResult, SimBackend, serve
from repro_torch.serving.traffic import (TrafficPhase, alternating_traffic,
                                         make_requests, uniform_traffic)
