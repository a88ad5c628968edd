"""Host-side utilities: logging with W3C trace context, the hot-path marker,
and device selection."""
