"""Model zoo of the port (port of ``daft_tpu/models``): ``torch.nn`` modules
holding the JAX models' arithmetic. The CLIP towers, MiniLM, BERT and the
decoder LM are imported from their modules; ResNet-18 is exported here, as
the JAX package exports it."""

from daft_tpu_torch.models.resnet import (
    ResNet18,
    ResNetConfig,
    init_resnet_params,
    load_flax_resnet,
)

__all__ = ["ResNet18", "ResNetConfig", "init_resnet_params", "load_flax_resnet"]
