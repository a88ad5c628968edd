"""One deadline-based readiness wait for the tests that start a frontend
process: poll its ``/v1/models`` until the model is listed, and fail with
a clear message (the last answer included) when it never is."""

import asyncio
import time
from typing import Optional

import aiohttp

READY_TIMEOUT_S = 60.0


async def wait_for_model(port: int, model: Optional[str] = None,
                         timeout: float = READY_TIMEOUT_S,
                         interval: float = 0.05) -> None:
    """Return once the frontend on ``port`` lists ``model`` (any model
    when None) under ``/v1/models``."""
    deadline = time.monotonic() + timeout
    last = None
    url = f"http://127.0.0.1:{port}/v1/models"
    async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=10)) as session:
        while True:
            try:
                async with session.get(url) as resp:
                    body = await resp.json()
                last = (resp.status, body)
                ids = [m["id"] for m in body.get("data", [])]
                if (model in ids) if model is not None else ids:
                    return
            except (aiohttp.ClientError, ValueError) as e:
                last = repr(e)
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"the frontend on port {port} never listed "
                    f"{model or 'a model'} in {timeout:.0f} s; its last "
                    f"answer: {last}")
            await asyncio.sleep(interval)
