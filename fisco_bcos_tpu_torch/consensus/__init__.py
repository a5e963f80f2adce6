"""Consensus: the quorum-certificate seal judge (qc.verify_spans). The
PBFT engine is not ported yet (ROADMAP.md)."""
