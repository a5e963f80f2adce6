from .sync import BlockSync

__all__ = ["BlockSync"]
