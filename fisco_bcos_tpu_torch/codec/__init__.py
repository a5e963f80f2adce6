"""Deterministic wire codec."""
