"""The paper's own simulation model: the CNN of McMahan et al. [1]
(two 5x5 conv layers 32/64 + 2x2 maxpool each + fc512), used for the
MNIST / CIFAR-10 / CIFAR-100 convergence experiments (Figs. 2-4).

This is not one of the assigned pool architectures; it is registered so the
FL repro drivers can select it with ``--arch paper-cnn-<dataset>``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    image_size: int
    channels: int
    num_classes: int
    conv_channels: tuple = (32, 64)
    kernel: int = 5
    fc_width: int = 512


MNIST_CNN = CNNConfig("paper-cnn-mnist", image_size=28, channels=1, num_classes=10)
CIFAR10_CNN = CNNConfig("paper-cnn-cifar10", image_size=32, channels=3, num_classes=10)
CIFAR100_CNN = CNNConfig(
    "paper-cnn-cifar100", image_size=32, channels=3, num_classes=100
)

CNN_CONFIGS = {c.name: c for c in (MNIST_CNN, CIFAR10_CNN, CIFAR100_CNN)}
