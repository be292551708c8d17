"""Model zoo: standard architectures as config builders."""
from .zoo import TransformerLM, ZooModel  # noqa: F401

__all__ = ["ZooModel", "TransformerLM"]
