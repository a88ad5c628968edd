"""Parallel building blocks of the port. One device so far: the MoE FFN
(``moe.py``); tensor, sequence, pipeline and expert-parallel sharding
stay with ROADMAP.md queue A, item 6."""
