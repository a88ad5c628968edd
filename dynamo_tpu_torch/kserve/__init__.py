"""KServe v2 gRPC inference frontend
(ref: lib/llm/src/grpc/service/kserve.rs — the tonic GrpcInferenceService).

The port's copy of ``dynamo_tpu.kserve``, on its own HTTP/2, HPACK and
protobuf codec (``utils/http2.py``, ``utils/hpack.py``,
``utils/protowire.py``; ``grpc.py`` is the gRPC layer, ``messages.py`` the
messages of ``kserve.proto``), so it runs where ``grpc`` and
``google.protobuf`` are not installed. Its peers may be grpc's own clients
and servers: the bytes on the wire are the same.
"""

from .service import KserveGrpcService, make_stub

__all__ = ["KserveGrpcService", "make_stub"]
