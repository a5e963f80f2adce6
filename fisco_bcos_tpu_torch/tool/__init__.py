"""Node tools: the peer-median clock (`timesync`). The ini config loader
(`tool/config.py`) comes with the process daemon and is not ported."""

from .timesync import NodeTimeMaintenance

__all__ = ["NodeTimeMaintenance"]
