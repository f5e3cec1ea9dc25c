"""Model zoo of the PyTorch port (counterpart of ``p2pfl_tpu/models``):
parameter-free modules bound to parameter trees in flax's layout.

The reference's MLP and CNN (MNIST), ResNet-18/50 and the ViT (CIFAR
shapes); the transformer is ``models/transformer.py``.
"""

from p2pfl_tpu_torch.models.base import TorchModel, apply_with_aux
from p2pfl_tpu_torch.models.vision import CNN, MLP, ResNet, ViT, cnn, mlp, resnet18, resnet50, vit

__all__ = [
    "TorchModel", "apply_with_aux", "MLP", "CNN", "ResNet", "ViT",
    "mlp", "cnn", "resnet18", "resnet50", "vit",
]
