"""Vision models (counterpart of paddle_tpu/vision/models): the ResNet
family is ported. VGG, MobileNet v1-v3, DenseNet, the classic nets
(LeNet, AlexNet, GoogLeNet, SqueezeNet), ShuffleNetV2 and InceptionV3
are not: each of their names raises NotImplementedError when called
(ROADMAP Queue 1 item 11)."""
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext101_32x8d,
    wide_resnet50_2, wide_resnet101_2,
)

_NOT_PORTED = (
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "MobileNetV2", "MobileNetV3Large", "MobileNetV3Small",
    "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_large",
    "mobilenet_v3_small",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264",
    "AlexNet", "GoogLeNet", "LeNet", "SqueezeNet", "alexnet", "googlenet",
    "squeezenet1_0", "squeezenet1_1",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "InceptionV3", "inception_v3",
)


def _not_ported(name):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"vision.models.{name} is not ported yet (only the ResNet "
            f"family is; ROADMAP Queue 1 item 11)")
    build.__name__ = build.__qualname__ = name
    return build


globals().update({n: _not_ported(n) for n in _NOT_PORTED})
