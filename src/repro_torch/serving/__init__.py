"""Serving layer for CAM similarity search.

Continuous-batching front end over the search-plan engine: concurrent
KNN / HDC / forest query requests are coalesced into plan-sized
micro-batches against one cached (optionally sharded) plan
(:class:`CamSearchServer`), with live gallery updates, a device-fault
model, deadlines, retries, a circuit breaker and a degraded fallback
chain on the CPU.  On top of it sits the multi-tenant
:class:`CamServingGateway`: named tenants, per-tenant admission control
(rate limits, priorities, load shedding), gallery replicas
load-balanced across device groups with transparent failover, and
digest-checked replica healing.
"""

from .gateway import CamServingGateway, GatewayRequest, GatewayResult
from .replica import Replica, ReplicaSet
from .server import CamSearchServer, SearchRequest, SearchResult
from .telemetry import ServerStats
from .tenant import AdmissionConfig, AdmissionError, TenantUnavailable

__all__ = ["CamSearchServer", "SearchRequest", "SearchResult",
           "ServerStats", "CamServingGateway", "GatewayRequest",
           "GatewayResult", "Replica", "ReplicaSet", "AdmissionConfig",
           "AdmissionError", "TenantUnavailable"]
