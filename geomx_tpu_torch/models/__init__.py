"""geomx_tpu_torch.models — the port's model zoo: LeNet, the MLP, the
transformer and its MoE block, ResNet, the vision zoo and the recurrent
language models (counterpart of ``geomx_tpu/models``)."""

from geomx_tpu_torch.models.cnn import LeNetCNN, create_cnn  # noqa: F401
from geomx_tpu_torch.models.mlp import MLP  # noqa: F401
from geomx_tpu_torch.models.moe import (  # noqa: F401
    MoEBlock, moe_param_sharding)
from geomx_tpu_torch.models.resnet import ResNet, create_resnet  # noqa: F401
from geomx_tpu_torch.models.transformer import (  # noqa: F401
    Block, Transformer, dense_attention, make_attention,
    transformer_param_sharding)
from geomx_tpu_torch.models.zoo import (  # noqa: F401
    AlexNet, DenseNet, InceptionV3, MobileNetV1, MobileNetV2, SqueezeNet,
    VGG, get_model)
