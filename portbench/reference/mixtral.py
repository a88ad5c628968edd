"""Mixtral is the Mistral block with routed experts: ``reference/mistral.py``
computes it whole."""

from portbench.reference.mistral import *  # noqa: F401,F403
