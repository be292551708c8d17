"""Model zoo: standard architectures as config builders."""
from .zoo import LeNet, ResNet50, TransformerLM, ZooModel  # noqa: F401

__all__ = ["ZooModel", "LeNet", "ResNet50", "TransformerLM"]
