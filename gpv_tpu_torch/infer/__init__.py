from .build import build_engine

__all__ = ["build_engine"]
