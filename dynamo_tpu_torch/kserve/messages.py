"""Every message of ``kserve.proto`` (the KServe v2 / open inference
protocol subset the JAX package serves, ``dynamo_tpu/kserve/kserve.proto``,
package ``inference``), as schema tables for ``utils/protowire.py``.

The port's twin of the generated ``kserve_pb2.py``: the same message names
(nested ones as class attributes: ``ModelInferRequest.InferInputTensor``),
field names, numbers and types, so the bytes each writes parse in the other
to an equal message. Every field is decoded, ``InferTensorContents``' typed
lists and ``raw_input_contents`` included, though the service reads only
some of them.
"""

from __future__ import annotations

from ..utils.protowire import Message, field, map_field

SERVICE = "inference.GRPCInferenceService"


class ServerLiveRequest(Message):
    FIELDS = ()


class ServerLiveResponse(Message):
    FIELDS = (field(1, "live", "bool"),)


class ServerReadyRequest(Message):
    FIELDS = ()


class ServerReadyResponse(Message):
    FIELDS = (field(1, "ready", "bool"),)


class ModelReadyRequest(Message):
    FIELDS = (field(1, "name", "string"), field(2, "version", "string"))


class ModelReadyResponse(Message):
    FIELDS = (field(1, "ready", "bool"),)


class ModelMetadataRequest(Message):
    FIELDS = (field(1, "name", "string"), field(2, "version", "string"))


class ModelMetadataResponse(Message):
    class TensorMetadata(Message):
        FIELDS = (
            field(1, "name", "string"),
            field(2, "datatype", "string"),
            field(3, "shape", "int64", repeated=True),
        )

    FIELDS = (
        field(1, "name", "string"),
        field(2, "versions", "string", repeated=True),
        field(3, "platform", "string"),
        field(4, "inputs", "message", repeated=True, message=TensorMetadata),
        field(5, "outputs", "message", repeated=True, message=TensorMetadata),
    )


class InferParameter(Message):
    FIELDS = (
        field(1, "bool_param", "bool", oneof="parameter_choice"),
        field(2, "int64_param", "int64", oneof="parameter_choice"),
        field(3, "string_param", "string", oneof="parameter_choice"),
        field(4, "double_param", "double", oneof="parameter_choice"),
    )


class InferTensorContents(Message):
    FIELDS = (
        field(1, "bool_contents", "bool", repeated=True),
        field(2, "int_contents", "int32", repeated=True),
        field(3, "int64_contents", "int64", repeated=True),
        field(4, "uint_contents", "uint32", repeated=True),
        field(5, "uint64_contents", "uint64", repeated=True),
        field(6, "fp32_contents", "float", repeated=True),
        field(7, "fp64_contents", "double", repeated=True),
        field(8, "bytes_contents", "bytes", repeated=True),
    )


def _parameters(number: int):
    return map_field(number, "parameters", "string", "message",
                     message=InferParameter)


class ModelInferRequest(Message):
    class InferInputTensor(Message):
        FIELDS = (
            field(1, "name", "string"),
            field(2, "datatype", "string"),
            field(3, "shape", "int64", repeated=True),
            _parameters(4),
            field(5, "contents", "message", message=InferTensorContents),
        )

    class InferRequestedOutputTensor(Message):
        FIELDS = (field(1, "name", "string"), _parameters(2))

    FIELDS = (
        field(1, "model_name", "string"),
        field(2, "model_version", "string"),
        field(3, "id", "string"),
        _parameters(4),
        field(5, "inputs", "message", repeated=True,
              message=InferInputTensor),
        field(6, "outputs", "message", repeated=True,
              message=InferRequestedOutputTensor),
        field(7, "raw_input_contents", "bytes", repeated=True),
    )


class ModelInferResponse(Message):
    class InferOutputTensor(Message):
        FIELDS = (
            field(1, "name", "string"),
            field(2, "datatype", "string"),
            field(3, "shape", "int64", repeated=True),
            _parameters(4),
            field(5, "contents", "message", message=InferTensorContents),
        )

    FIELDS = (
        field(1, "model_name", "string"),
        field(2, "model_version", "string"),
        field(3, "id", "string"),
        _parameters(4),
        field(5, "outputs", "message", repeated=True,
              message=InferOutputTensor),
        field(6, "raw_output_contents", "bytes", repeated=True),
    )


class ModelStreamInferResponse(Message):
    FIELDS = (
        field(1, "error_message", "string"),
        field(2, "infer_response", "message", message=ModelInferResponse),
    )


# every message of the file, by its name in ``kserve.proto`` (nested ones
# as ``Outer.Inner``)
MESSAGES = {
    cls.__qualname__: cls for cls in (
        ServerLiveRequest, ServerLiveResponse, ServerReadyRequest,
        ServerReadyResponse, ModelReadyRequest, ModelReadyResponse,
        ModelMetadataRequest, ModelMetadataResponse,
        ModelMetadataResponse.TensorMetadata, InferParameter,
        InferTensorContents, ModelInferRequest,
        ModelInferRequest.InferInputTensor,
        ModelInferRequest.InferRequestedOutputTensor, ModelInferResponse,
        ModelInferResponse.InferOutputTensor, ModelStreamInferResponse)
}
