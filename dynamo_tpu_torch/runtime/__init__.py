"""Host-side runtime pieces: request contexts with cancellation, the
``AsyncEngine`` streaming abstraction with its pipeline operators, and the
transport's error codes."""

from .context import Context
from .engine import AsyncEngine, FnEngine, Operator, link

__all__ = ["Context", "AsyncEngine", "FnEngine", "Operator", "link"]
