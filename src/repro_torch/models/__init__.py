"""Model stack: layers, GQA attention, MoE, blocks and the LM facade."""

from .model import LM  # noqa: F401
