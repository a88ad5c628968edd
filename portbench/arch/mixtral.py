"""Mixtral (``model_type`` ``mixtral``) is the Mistral block with routed
experts: ``arch/mistral.py`` serves it whole."""

from portbench.arch.mistral import *  # noqa: F401,F403
