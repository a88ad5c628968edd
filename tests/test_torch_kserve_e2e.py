"""The KServe gRPC entry point of the port end to end on the CPU: the
frontend process (``python -m dynamo_tpu_torch.frontend --grpc-port 0``)
over a ``--device cpu`` worker process holding ``ModelConfig.tiny()`` at
float32, greedy. Each prompt's text through gRPC (``ModelInfer`` and
``ModelStreamInfer``, from the port's client and from ``grpc``'s) equals
``/v1/completions`` from the same frontend, and the JAX pipeline's text
for the same prompts over the same weights (the worker's, seed 0)."""

import asyncio
import re
import signal
import sys
from pathlib import Path

import aiohttp
import grpc
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.frontend import service as jsvc
from dynamo_tpu.kserve import kserve_pb2 as jpb
from dynamo_tpu.kserve.service import make_stub as jax_stub
from dynamo_tpu.llm.entrypoint import build_local_pipeline as jax_pipeline
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu_torch.engine import ModelConfig
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.kserve import grpc as tgrpc
from dynamo_tpu_torch.kserve import make_stub
from dynamo_tpu_torch.kserve import messages as tpb

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_distributed import start_cluster, tok_file  # noqa: E402,F401
from test_torch_frontend_http import (  # noqa: E402
    ENG_KW, TIMEOUT, fetch, tiny_tokenizer,
)
from torch_ready import wait_for_model  # noqa: E402

PROMPTS = [("It's 12 o'clock, the", 8), ("hello world", 10),
           ("The quick brown fox", 12)]
# the worker's engine settings, as ENG_KW's
WORKER_FLAGS = ("--block-size", str(ENG_KW["block_size"]),
                "--max-num-seqs", str(ENG_KW["max_num_seqs"]),
                "--max-batched-tokens", str(ENG_KW["max_num_batched_tokens"]),
                "--max-model-len", str(ENG_KW["max_model_len"]))


def jax_texts():
    """The JAX pipeline's greedy completions over the worker's weights
    (``init_params`` seeded 0, as ``--model tiny`` builds them)."""
    params = init_params(torch.Generator("cpu").manual_seed(0),
                         ModelConfig.tiny())
    tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jeng = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**ENG_KW),
                     params=tree, seed=0)
    pipeline = jax_pipeline(jeng, JaxTokenizer(tiny_tokenizer()), "tiny",
                            ENG_KW["max_model_len"])

    async def serve():
        manager = jsvc.ModelManager()
        manager.register(jsvc.ModelEntry(name="tiny", engine=pipeline))
        svc = jsvc.HttpService(manager, host="127.0.0.1", port=0)
        await jeng.start()
        await svc.start()
        try:
            return await http_texts(svc.port)
        finally:
            await svc.stop()
            await jeng.stop()
    return asyncio.run(serve())


async def http_texts(port):
    out = []
    async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
        for prompt, n in PROMPTS:
            status, _, body = await fetch(s, port, "POST", "/v1/completions",
                                          {"model": "tiny", "prompt": prompt,
                                           "max_tokens": n,
                                           "temperature": 0})
            assert status == 200, body
            out.append(body["choices"][0]["text"])
    return out


def _request(pb, prompt, n, port_client):
    params = {"max_tokens": n, "temperature": 0.0}
    if port_client:
        return pb.ModelInferRequest(
            model_name="tiny", id=prompt,
            parameters={"max_tokens": pb.InferParameter(int64_param=n),
                        "temperature": pb.InferParameter(double_param=0.0)},
            inputs=[pb.ModelInferRequest.InferInputTensor(
                name="text_input", datatype="BYTES", shape=[1],
                contents=pb.InferTensorContents(
                    bytes_contents=[prompt.encode()]))])
    req = pb.ModelInferRequest(model_name="tiny", id=prompt)
    t = req.inputs.add()
    t.name, t.datatype = "text_input", "BYTES"
    t.shape.append(1)
    t.contents.bytes_contents.append(prompt.encode())
    req.parameters["max_tokens"].int64_param = params["max_tokens"]
    req.parameters["temperature"].double_param = params["temperature"]
    return req


async def grpc_texts(port, port_client: bool):
    """(unary texts, streamed texts, the unary finish reasons)."""
    pb = tpb if port_client else jpb
    chan = (tgrpc.insecure_channel(f"127.0.0.1:{port}") if port_client
            else grpc.aio.insecure_channel(f"127.0.0.1:{port}"))
    stub = (make_stub if port_client else jax_stub)(chan)
    unary, streamed, reasons = [], [], []
    try:
        for prompt, n in PROMPTS:
            resp = await stub.ModelInfer(_request(pb, prompt, n, port_client),
                                         timeout=60)
            unary.append(resp.outputs[0].contents.bytes_contents[0].decode())
            reasons.append(resp.parameters["finish_reason"].string_param)
            call = stub.ModelStreamInfer()
            await call.write(_request(pb, prompt, n, port_client))
            await call.done_writing()
            parts = []
            async for r in call:
                assert not r.error_message, r.error_message
                parts.append(r.infer_response.outputs[0].contents
                             .bytes_contents[0].decode())
            streamed.append("".join(parts))
    finally:
        await chan.close()
    return unary, streamed, reasons


@pytest.fixture(scope="module")
def jax_want():
    return jax_texts()


def test_grpc_text_equals_http_and_the_jax_pipeline(tmp_path, tok_file,
                                                    jax_want):
    procs, port = start_cluster(tmp_path, tok_file, 1, *WORKER_FLAGS,
                                frontend_flags=("--grpc-port", "0"))
    try:
        grpc_port = int(procs["frontend"].wait_for(
            r"kserve grpc on 127\.0\.0\.1:(\d+)").group(1))
        assert grpc_port not in (0, port)

        async def drive():
            await wait_for_model(port, "tiny")
            return (await http_texts(port), await grpc_texts(grpc_port, True),
                    await grpc_texts(grpc_port, False))
        http, (unary, streamed, reasons), via_grpc_client = \
            asyncio.run(drive())
        assert all(jax_want)
        assert http == jax_want
        assert unary == streamed == http
        assert via_grpc_client == (unary, streamed, reasons)
        assert set(reasons) <= {"length", "stop"}
        assert procs["frontend"].stop() == 0
        log = procs["frontend"].log.read_text()
        assert not re.search(r"Traceback|ERROR", log), log[-3000:]
    finally:
        for p in procs.values():
            p.stop(signal.SIGKILL)
