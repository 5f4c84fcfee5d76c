"""The port's models, the counterparts of ``horovod_tpu.models``: the
flagship TransformerLM (``models.transformer``), the ResNets
(``models.resnet``, with ``models.fused_block`` and the lane-folded
``models.folded_bn``), VGG (``models.vgg``), Inception V3
(``models.inception``) and the MNIST models (``models.mlp``)."""

from horovod_tpu_torch.models.folded_bn import FoldedBatchNorm
from horovod_tpu_torch.models.fused_block import (fused_to_plain_variables,
                                                  plain_to_fused_variables)
from horovod_tpu_torch.models.inception import InceptionV3
from horovod_tpu_torch.models.mlp import MLP, MnistCNN
from horovod_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                             ResNet18, ResNet34, ResNet50,
                                             ResNet101, ResNet152,
                                             ResNetBlock)
from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from horovod_tpu_torch.models.vgg import VGG, VGG11, VGG16, VGG19

__all__ = ["BottleneckBlock", "FoldedBatchNorm", "InceptionV3", "MLP",
           "MnistCNN", "ResNet", "ResNet101", "ResNet152", "ResNet18",
           "ResNet34", "ResNet50", "ResNetBlock", "TransformerConfig",
           "TransformerLM", "VGG", "VGG11", "VGG16", "VGG19",
           "fused_to_plain_variables", "plain_to_fused_variables"]
