"""Training of the port: the train step (``step``) and the loop (``loop``)."""
from . import loop, step

__all__ = ["loop", "step"]
