"""Model zoo: standard architectures as config builders."""
from .zoo import (ZOO, LeNet, ModelSelector, ResNet50, SimpleCNN,  # noqa: F401
                  TextGenerationLSTM, TransformerLM, ZooModel, generate_tokens)

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "ResNet50", "TextGenerationLSTM", "TransformerLM",
           "generate_tokens", "ZOO", "ModelSelector"]
