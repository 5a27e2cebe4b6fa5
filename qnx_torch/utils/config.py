"""Config system (torch port of :mod:`qnx.utils.config`): frozen
dataclasses, one preset per BASELINE.json entry.

The same fields, defaults, presets and derived names as the JAX package's
``Config``, so the port runs on a host without the JAX package;
``tests/test_torch_config.py`` holds every preset equal to the original.

``network_type`` semantics (reference convention):

=========== ==================== =============================
type        weights              activations
=========== ==================== =============================
float       float                relu
qnn         ``wbits``-bit        relu
full-qnn    ``wbits``-bit        ``abits``-bit quantized_relu
bnn         binary {-H,+H}       relu
full-bnn    binary               binary_tanh (abits=1)
tnn         ternary {-H,0,+H}    relu
full-tnn    ternary              abits=1 -> binary_tanh, else quantized_relu
=========== ==================== =============================
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

NETWORK_TYPES = ("float", "qnn", "full-qnn", "bnn", "full-bnn", "tnn", "full-tnn")


@dataclass(frozen=True)
class Config:
    # data / model selection
    dataset: str = "MNIST"  # MNIST | CIFAR-10 | SVHN | digits | synthetic
    architecture: str = "mlp"  # mlp | vgg
    network_type: str = "full-bnn"
    wbits: int = 1
    abits: int = 1
    # architecture knobs
    dim: int = 4096  # MLP hidden width (BinaryNet: 4096)
    num_hidden: int = 3  # MLP hidden layers
    width: int = 128  # VGG base channel count (BinaryNet CIFAR: 128)
    dense_units: int = 1024  # VGG head width
    classes: int = 10
    first_layer_float: bool = False  # float first layer (CIFAR cfgs)
    last_layer_float: bool = False
    use_bias: bool = False
    batch_norm_momentum: float = 0.9
    batch_norm_epsilon: float = 1e-4
    dropout_rate: float = 0.0
    H: str | float = "Glorot"
    # activation override: None derives the activation from
    # network_type/abits (table above); an explicit op name — binary_tanh |
    # binary_sigmoid | quantized_relu | quantized_tanh | relu — selects that
    # op for every hidden layer.  The packed engine lowers only the binary
    # family (binary_tanh, binary_sigmoid).
    activation: str | None = None
    stochastic: bool = False  # stochastic binarization (BinaryConnect)
    ternary_style: str = "dingke"  # dingke | twn
    # training
    loss: str = "squared_hinge"  # squared_hinge | crossentropy
    lr_start: float = 1e-3
    lr_end: float = 1e-6
    epochs: int = 50
    batch_size: int = 100
    seed: int = 0
    kernel_lr_multiplier: float | None = None  # None -> 1/H (Glorot rule)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def input_shape(self):
        return {
            "MNIST": (28, 28, 1),
            "digits": (8, 8, 1),
            "CIFAR-10": (32, 32, 3),
            "SVHN": (32, 32, 3),
            "synthetic-mnist": (28, 28, 1),
            "synthetic-cifar": (32, 32, 3),
            "ImageNet": (224, 224, 3),
        }[self.dataset]

    def weight_quantizer_name(self) -> str:
        t = self.network_type
        if t == "float":
            return "float"
        if t in ("bnn", "full-bnn"):
            return "binary"
        if t in ("tnn", "full-tnn"):
            return "ternary"
        return "quant"  # qnn / full-qnn -> wbits

    def activation_name(self) -> str:
        if self.activation is not None:
            return self.activation
        t = self.network_type
        if t in ("float", "qnn", "bnn", "tnn"):
            return "relu"
        # full-* : quantized activations; abits==1 means binary_tanh
        return "binary" if self.abits == 1 else "quant"


# ---------------------------------------------------------------------------
# The five operative configs from BASELINE.json.
# ---------------------------------------------------------------------------

MNIST_BNN = Config(
    dataset="MNIST", architecture="mlp", network_type="full-bnn",
    wbits=1, abits=1, dim=4096, num_hidden=3,
)

MNIST_TNN = Config(
    dataset="MNIST", architecture="mlp", network_type="full-tnn",
    wbits=2, abits=1, dim=4096, num_hidden=3,
)

CIFAR10_BNN = Config(
    dataset="CIFAR-10", architecture="vgg", network_type="full-bnn",
    wbits=1, abits=1, width=128, first_layer_float=True, last_layer_float=True,
)

CIFAR10_TNN = Config(
    dataset="CIFAR-10", architecture="vgg", network_type="full-tnn",
    wbits=2, abits=2, width=128, first_layer_float=True, last_layer_float=True,
)

# serving config = CIFAR-10 BNN model under the continuous-batching engine
# (qnx_torch.serve); model hyperparameters identical to CIFAR10_BNN
CIFAR10_BNN_SERVE = CIFAR10_BNN

# SVHN uses the same VGG topology as CIFAR (32x32x3 inputs; BinaryNet
# trains it with fewer epochs since SVHN has ~600k train images)
SVHN_BNN = CIFAR10_BNN.replace(dataset="SVHN", epochs=20)

# Bi-Real Net-18 (Liu et al., ECCV 2018, arXiv:1808.00278) on ImageNet, a
# preset of the port only (the JAX package has no residual model): a float
# 7x7 stem, 16 binary 3x3 convs in four stages of base width ``width`` x
# (1, 2, 4, 8), each with a float shortcut around it, and a float head;
# BatchNorm's epsilon is PyTorch's, which the published code uses
IMAGENET_BIREAL18 = Config(
    dataset="ImageNet", architecture="bireal18", network_type="full-bnn",
    wbits=1, abits=1, width=64, classes=1000, first_layer_float=True,
    last_layer_float=True, batch_norm_epsilon=1e-5,
)

CONFIGS = {
    "mnist-bnn": MNIST_BNN,
    "mnist-tnn": MNIST_TNN,
    "cifar10-bnn": CIFAR10_BNN,
    "cifar10-tnn": CIFAR10_TNN,
    "cifar10-bnn-serve": CIFAR10_BNN_SERVE,
    "svhn-bnn": SVHN_BNN,
    "imagenet-bireal18": IMAGENET_BIREAL18,
}
