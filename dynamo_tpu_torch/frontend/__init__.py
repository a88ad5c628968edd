"""OpenAI-compatible HTTP frontend over the port's own asyncio HTTP/1.1
server."""
