"""Composition root (libinitializer counterpart)."""

from .node import Node, NodeConfig

__all__ = ["Node", "NodeConfig"]
