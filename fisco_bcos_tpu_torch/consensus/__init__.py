"""Consensus: the PBFT engine (`pbft`) and the quorum-certificate seal
judge (`qc.verify_spans`)."""

from .pbft.engine import PBFTEngine

__all__ = ["PBFTEngine"]
