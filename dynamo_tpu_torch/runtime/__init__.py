"""Host-side runtime: request contexts with cancellation, the ``AsyncEngine``
streaming abstraction with its pipeline operators, the lease-KV discovery
store, the request transport over TCP, the namespace → component → endpoint
model over both, and their wire codec (MessagePack, byte-equal to the JAX
package's)."""

from .component import (
    Client, Component, DistributedRuntime, Endpoint, Namespace,
    ServedEndpoint,
)
from .context import Context
from .engine import AsyncEngine, FnEngine, Operator, link
from .store import StoreClient, StoreServer
from .transport import EngineError, IngressServer, TransportClient

__all__ = [
    "AsyncEngine",
    "Client",
    "Component",
    "Context",
    "DistributedRuntime",
    "Endpoint",
    "EngineError",
    "FnEngine",
    "IngressServer",
    "Namespace",
    "Operator",
    "ServedEndpoint",
    "StoreClient",
    "StoreServer",
    "TransportClient",
    "link",
]
