from .moduleid import ModuleID
from .front import FrontService
from .gateway import FakeGateway, Gateway

__all__ = ["ModuleID", "FrontService", "FakeGateway", "Gateway"]
