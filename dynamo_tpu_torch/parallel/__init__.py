"""Parallel building blocks of the port: the sharding layout
(``layout.py``), the collectives (``comm.py``), the MoE FFN with expert
parallelism (``moe.py``), ring and Ulysses sequence-parallel attention
(``ring_attention.py``, ``ulysses.py``), the GPipe schedule and the
pipeline-parallel serving step with stages as ranks (``pipeline.py``,
``pp_serving.py``) and multi-controller serving over
``torch.distributed`` (``multihost.py``: the leader schedules, followers
replay its step plans)."""
