from .worker import Worker

__all__ = ["Worker"]
