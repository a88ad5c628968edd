"""KServe v2 gRPC service over the same ModelManager the HTTP frontend uses
(ref: grpc/service/kserve.rs:625 — ServerLive/Ready, ModelReady/Metadata,
ModelInfer, ModelStreamInfer).

A copy of ``dynamo_tpu.kserve.service``, function for function, on the
port's gRPC layer (``grpc.py``) and messages (``messages.py``) in place of
``grpc.aio`` and ``kserve_pb2``: the same RPCs, statuses and details.

LLM convention (matching the reference's text handling): input tensor
``text_input`` (BYTES) carries the prompt; request ``parameters`` carry
sampling options (``max_tokens``, ``temperature``, ``top_k``); the response
streams ``text_output`` (BYTES) tensors, one per generation step for
ModelStreamInfer, or one aggregated tensor for unary ModelInfer.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

from ..runtime.context import Context
from ..runtime.transport import EngineError
from ..utils.logging import get_logger
from . import grpc
from . import messages as pb

log = get_logger("kserve")

_SERVICE = pb.SERVICE


def _param(p: pb.InferParameter):
    which = p.which_oneof("parameter_choice")
    return getattr(p, which) if which else None


def _text_from_request(req: pb.ModelInferRequest) -> Optional[str]:
    for i, tensor in enumerate(req.inputs):
        if tensor.name != "text_input":
            continue
        if tensor.contents is not None and tensor.contents.bytes_contents:
            return tensor.contents.bytes_contents[0].decode()
        if i < len(req.raw_input_contents):
            raw = req.raw_input_contents[i]
            # raw BYTES tensors are length-prefixed (u32 LE) per the spec
            if len(raw) >= 4:
                n = int.from_bytes(raw[:4], "little")
                return raw[4:4 + n].decode()
            return raw.decode()
    return None


def _body_from_request(req: pb.ModelInferRequest) -> dict:
    body = {"model": req.model_name, "prompt": _text_from_request(req) or ""}
    params = {k: _param(v) for k, v in req.parameters.items()}
    for key in ("max_tokens", "temperature", "top_k", "top_p", "seed"):
        if params.get(key) is not None:
            body[key] = params[key]
    if params.get("ignore_eos") is not None:
        body["ignore_eos"] = bool(params["ignore_eos"])
    return body


def _text_response(req: pb.ModelInferRequest, text: str,
                   finish_reason: Optional[str] = None
                   ) -> pb.ModelInferResponse:
    resp = pb.ModelInferResponse(
        model_name=req.model_name, model_version=req.model_version,
        id=req.id,
    )
    resp.outputs.append(pb.ModelInferResponse.InferOutputTensor(
        name="text_output", datatype="BYTES", shape=[1],
        contents=pb.InferTensorContents(bytes_contents=[text.encode()]),
    ))
    if finish_reason:
        resp.parameters["finish_reason"] = pb.InferParameter(
            string_param=finish_reason)
    return resp


class KserveGrpcService:
    """gRPC server exposing the ModelManager's engines."""

    def __init__(self, manager, host: str = "0.0.0.0", port: int = 8001):
        self.manager = manager
        self.host = host
        self.port = port
        self._server: Optional[grpc.Server] = None

    # --------------------------- lifecycle ------------------------------

    async def start(self) -> None:
        self._server = grpc.Server(self._handler())
        self.port = await self._server.start(self.host, self.port)
        log.info("kserve grpc on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None

    def _handler(self):
        def u(fn, req_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.decode,
                response_serializer=lambda m: m.encode(),
            )

        handlers = {
            "ServerLive": u(self._server_live, pb.ServerLiveRequest),
            "ServerReady": u(self._server_ready, pb.ServerReadyRequest),
            "ModelReady": u(self._model_ready, pb.ModelReadyRequest),
            "ModelMetadata": u(self._model_metadata,
                               pb.ModelMetadataRequest),
            "ModelInfer": u(self._model_infer, pb.ModelInferRequest),
            "ModelStreamInfer": grpc.stream_stream_rpc_method_handler(
                self._model_stream_infer,
                request_deserializer=pb.ModelInferRequest.decode,
                response_serializer=lambda m: m.encode(),
            ),
        }
        return {f"/{_SERVICE}/{name}": h for name, h in handlers.items()}

    # ----------------------------- rpcs ---------------------------------

    async def _server_live(self, request, context) -> pb.ServerLiveResponse:
        return pb.ServerLiveResponse(live=True)

    async def _server_ready(self, request, context) -> pb.ServerReadyResponse:
        return pb.ServerReadyResponse(ready=bool(self.manager.list()))

    async def _model_ready(self, request, context) -> pb.ModelReadyResponse:
        return pb.ModelReadyResponse(ready=request.name in self.manager)

    async def _model_metadata(self, request, context):
        entry = self.manager.get(request.name)
        if entry is None:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"model {request.name!r} not found")
        tensor = pb.ModelMetadataResponse.TensorMetadata
        return pb.ModelMetadataResponse(
            name=entry.name, platform="dynamo-tpu", versions=["1"],
            inputs=[tensor(name="text_input", datatype="BYTES", shape=[1])],
            outputs=[tensor(name="text_output", datatype="BYTES",
                            shape=[1])],
        )

    async def _generate(self, request) -> AsyncIterator[tuple]:
        """Yields (text, finish_reason) steps from the routed engine."""
        entry = self.manager.get(request.model_name)
        if entry is None:
            raise KeyError(f"model {request.model_name!r} not found")
        body = _body_from_request(request)
        ctx = Context()
        async for out in entry.engine.generate(body, ctx):
            yield out.text or "", out.finish_reason

    async def _model_infer(self, request, context) -> pb.ModelInferResponse:
        try:
            parts = []
            finish = None
            async for text, reason in self._generate(request):
                parts.append(text)
                if reason:
                    finish = reason
            return _text_response(request, "".join(parts), finish)
        except KeyError as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except EngineError as e:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))

    async def _model_stream_infer(self, request_iterator, context):
        async for request in request_iterator:
            try:
                async for text, reason in self._generate(request):
                    yield pb.ModelStreamInferResponse(
                        infer_response=_text_response(request, text, reason)
                    )
            except KeyError as e:
                yield pb.ModelStreamInferResponse(error_message=str(e))
            except EngineError as e:
                yield pb.ModelStreamInferResponse(
                    error_message=f"{e.code}: {e}"
                )


def make_stub(channel: grpc.Channel):
    """Client-side stub over the port's channel (tests, ``chip_smoke.py``
    and probing from the command line)."""
    def u(method, req_cls, resp_cls):
        return channel.unary_unary(
            f"/{_SERVICE}/{method}",
            request_serializer=lambda m: m.encode(),
            response_deserializer=resp_cls.decode,
        )

    class Stub:
        ServerLive = u("ServerLive", pb.ServerLiveRequest,
                       pb.ServerLiveResponse)
        ServerReady = u("ServerReady", pb.ServerReadyRequest,
                        pb.ServerReadyResponse)
        ModelReady = u("ModelReady", pb.ModelReadyRequest,
                       pb.ModelReadyResponse)
        ModelMetadata = u("ModelMetadata", pb.ModelMetadataRequest,
                          pb.ModelMetadataResponse)
        ModelInfer = u("ModelInfer", pb.ModelInferRequest,
                       pb.ModelInferResponse)
        ModelStreamInfer = channel.stream_stream(
            f"/{_SERVICE}/ModelStreamInfer",
            request_serializer=lambda m: m.encode(),
            response_deserializer=pb.ModelStreamInferResponse.decode,
        )

    return Stub
