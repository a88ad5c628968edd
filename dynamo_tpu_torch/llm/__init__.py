"""LLM pipeline layer: tokenization (with the port's own ``tokenizer.json``
reader), preprocessing, backend post-processing, the OpenAI wire protocol
and stream parsers — a copy of the in-process part of ``dynamo_tpu.llm``."""
