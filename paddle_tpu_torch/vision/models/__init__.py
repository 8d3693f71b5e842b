"""The vision model zoo (counterpart of ``paddle_tpu/vision/models``):
the ResNet family (ResNet-18 to -152, the ResNeXt and wide variants),
LeNet, VGG, AlexNet and MobileNetV2, built from the port's ``nn``
layers (convolutions and pools in torch / cuDNN, the batch norms with
Paddle's buffers). The JAX package's ``extra.py`` models (MobileNetV1 /
V3, SqueezeNet, DenseNet, GoogLeNet, InceptionV3, ShuffleNetV2) wait for
a later slice (ROADMAP Queue 1, item 11)."""
from .alexnet import AlexNet, alexnet  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
    resnext152_32x4d, resnext152_64x4d, wide_resnet50_2, wide_resnet101_2,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2",
           "LeNet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "MobileNetV2", "mobilenet_v2", "AlexNet", "alexnet"]
