"""Host-side runtime pieces the engine needs: request contexts with
cancellation, and the ``AsyncEngine`` streaming abstraction."""

from .context import Context
from .engine import AsyncEngine

__all__ = ["Context", "AsyncEngine"]
