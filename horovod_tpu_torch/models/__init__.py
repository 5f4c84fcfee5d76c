"""The port's models: the flagship TransformerLM (``models.transformer``)
and the ResNets (``models.resnet``, with ``models.fused_block``)."""

from horovod_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                             ResNet18, ResNet34, ResNet50,
                                             ResNet101, ResNet152,
                                             ResNetBlock)

__all__ = ["BottleneckBlock", "ResNet", "ResNet101", "ResNet152", "ResNet18",
           "ResNet34", "ResNet50", "ResNetBlock"]
