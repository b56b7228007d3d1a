"""Serving layer for CAM similarity search.

Continuous-batching front end over the search-plan engine: concurrent
KNN / HDC / forest query requests are coalesced into plan-sized
micro-batches against one cached single-device plan
(:class:`CamSearchServer`), with live gallery updates, a device-fault
model, deadlines, retries, a circuit breaker and a degraded fallback
chain.  The reference's multi-tenant gateway, tenants and replica sets
come with sharding (ROADMAP Queue A item 5).
"""

from .server import CamSearchServer, SearchRequest, SearchResult
from .telemetry import ServerStats

__all__ = ["CamSearchServer", "SearchRequest", "SearchResult",
           "ServerStats"]
