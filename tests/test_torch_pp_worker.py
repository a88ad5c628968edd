"""The ``--pp 2`` worker over processes: a store, a one-rank worker and a
pipeline worker (rank 0 starts rank 1 itself on localhost) on the CPU,
in the style of ``test_torch_multihost.py``. The pipeline worker's greedy
streams equal the one-rank worker's, and at SIGTERM both stages log
their exit lines: the follower replayed exactly the plans the leader
emitted, with as many hops.
"""

import asyncio
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_distributed import Proc  # noqa: E402
from test_torch_multihost import (  # noqa: E402
    COMMON, EXIT_S, READY_S, _env, _stop_all, _store, tok,  # noqa: F401
)

PP_LINE = re.compile(r"worker exiting: pp rank=(\d) world=2 backend=gloo "
                     r"stage layers=(\d+)\.\.(\d+) plans=(\S+) "
                     r"ppermute_calls=(\d+) bytes=(\d+) ")


def test_pp_worker_serves_one_rank_streams(tmp_path, tok):
    """``--pp 2`` alone: the worker starts rank 1 itself on localhost; its
    greedy streams through the ``generate`` endpoint equal a one-rank
    worker's (same seed, same weights) on the same store; at SIGTERM both
    stages log their exit lines, the follower having replayed exactly the
    plans the leader emitted, with as many hops, and only the leader's
    stage sent activations."""
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    addr, store = _store(tmp_path)
    procs = {"store": store}
    common = [*COMMON[:-2], "--tokenizer", str(tok), "--store-addr", addr]
    procs["one"] = Proc(tmp_path, "one", "dynamo_tpu_torch.worker", *common,
                        "--component", "one", "--model-name", "tiny-1",
                        env=_env())
    procs["pp"] = Proc(tmp_path, "pp", "dynamo_tpu_torch.worker", *common,
                       "--pp", "2", "--component", "pp",
                       "--model-name", "tiny-pp", env=_env())
    try:
        procs["one"].wait_for(r"registered model tiny-1", timeout=READY_S)
        procs["pp"].wait_for(r"registered model tiny-pp", timeout=READY_S)
        assert "started local ranks [1]" in procs["pp"].log.read_text()

        async def streams(component):
            rt = await DistributedRuntime.from_settings(
                RuntimeConfig(store_addr=addr))
            try:
                client = await (rt.namespace().component(component)
                                .endpoint("generate").client())
                await client.wait_for_instances(1, timeout_s=READY_S)

                async def one(i):
                    toks = []
                    async for o in client.round_robin(
                            {"token_ids": list(range(3 + i, 40 + 7 * i)),
                             "max_tokens": 8, "ignore_eos": True},
                            Context()):
                        toks.extend(o["token_ids"])
                    return toks
                return await asyncio.gather(*(one(i) for i in range(3)))
            finally:
                await rt.shutdown()

        want = asyncio.run(asyncio.wait_for(streams("one"), READY_S))
        got = asyncio.run(asyncio.wait_for(streams("pp"), READY_S))
        assert [len(s) for s in got] == [8, 8, 8]
        assert got == want
        # SIGTERM drains the leader, whose child rank exits after it
        assert procs["pp"].stop(timeout=EXIT_S) == 0
        lines = {int(m.group(1)): m.groups()
                 for m in PP_LINE.finditer(procs["pp"].log.read_text())}
        assert sorted(lines) == [0, 1], procs["pp"].log.read_text()[-3000:]
        assert lines[0][1:3] == ("0", "0") and lines[1][1:3] == ("1", "1")
        assert lines[1][3] == lines[0][3]           # plans per kind
        assert "d:" in lines[0][3] and "p:" in lines[0][3]
        assert lines[1][4] == lines[0][4] != "0"    # hops
        assert lines[1][5] == "0" != lines[0][5]    # only stage 0 sends
    finally:
        _stop_all(procs)
