"""Model zoo: standard architectures as config builders."""
from .zoo import (ZOO, AlexNet, FaceNetNN4Small2, GoogLeNet, InceptionResNetV1,  # noqa: F401
                  LeNet, ModelSelector, ResNet50, SimpleCNN, TextGenerationLSTM, TransformerLM,
                  VGG16, VGG19, ZooModel, generate_tokens)

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19", "GoogLeNet",
           "ResNet50", "InceptionResNetV1", "FaceNetNN4Small2", "TextGenerationLSTM",
           "TransformerLM", "generate_tokens", "ZOO", "ModelSelector"]
