from .logger import Logger

__all__ = ["Logger"]
