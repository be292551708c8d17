"""HTTP plumbing shared by the port's servers (counterpart of
``deeplearning4j_tpu/ui/``; the training UI itself is ROADMAP A 17)."""
from .server import JsonRequestHandler, MAX_POST_BYTES  # noqa: F401

__all__ = ["JsonRequestHandler", "MAX_POST_BYTES"]
