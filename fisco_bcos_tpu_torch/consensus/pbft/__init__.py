from .engine import PBFTEngine
from .messages import PacketType, PBFTMessage

__all__ = ["PBFTEngine", "PacketType", "PBFTMessage"]
