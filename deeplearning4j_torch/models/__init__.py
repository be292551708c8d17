"""Model zoo: standard architectures as config builders."""
from .zoo import (ZOO, LeNet, ModelSelector, ResNet50, TextGenerationLSTM,  # noqa: F401
                  TransformerLM, ZooModel, generate_tokens)

__all__ = ["ZooModel", "LeNet", "ResNet50", "TextGenerationLSTM", "TransformerLM",
           "generate_tokens", "ZOO", "ModelSelector"]
