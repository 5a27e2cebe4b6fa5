"""Write the full-width goldens of the torch port: for each served config,
the logits that the JAX package's ``ServeEngine`` gives for 8 seeded uint8
images, with the random variables of
``qnx_torch.models.factory.init_variables(cf, seed=0)``:

* ``torch_port_golden_cifar10_bnn.npz``: the ``cifar10-bnn`` packed VGG;
* ``torch_port_golden_mnist_bnn.npz``: the ``mnist-bnn`` packed MLP;
* ``torch_port_golden_mnist_tnn.npz``: the ``mnist-tnn`` packed MLP;
* ``torch_port_golden_{cifar10_bnn,cifar10_tnn,mnist_bnn}_int8.npz``: the
  same configs through the int8 engine (``pack_int8``: pm1 codes, and level
  codes for ``cifar10-tnn``'s abits 2);
* ``torch_port_golden_cifar10_tnn.npz``: ``cifar10-tnn`` through the packed
  engine, which is the bit-plane engine at its abits 2
  (``pack_vgg_bitplane``);
* ``torch_port_golden_cifar10_tnn_a3.npz``: the same at abits 3 with a
  quantized head (two planes, three thresholds, ``PlaneDenseLogits``);
* ``torch_port_golden_cifar10_tnn_a1.npz``: the same at abits 1, the ternary
  packed VGG (``pack_vgg``'s ternary branch);
* ``torch_port_golden_cifar10_bnn_zo_int8.npz``: ``cifar10-bnn`` with
  binary_sigmoid activations through the int8 engine (``zo`` codes);
* ``torch_port_golden_cifar10_tnn_tanh_int8.npz`` and
  ``torch_port_golden_cifar10_tnn_tanh.npz``: ``cifar10-tnn`` with
  quantized_tanh activations through the int8 engine (signed ``tanh``
  codes) and through the bit-plane engine (tanh mode: two planes, the
  border term);
* ``torch_port_golden_cifar10_qnn_int8.npz``: ``cifar10-tnn`` as
  ``full-qnn`` with 4-bit grid weights through the int8 engine;
* ``torch_port_golden_cifar10_qnn_relu_int8.npz``: ``cifar10-bnn`` as the
  relu network type ``qnn`` with 4-bit weights (float relu activations,
  ``I8WConv`` / ``I8WDense`` / ``I8WHead``).

Each file holds the images and logits only, never the variables (the
full-width float latents are about 147 MB for an MLP); the int8 files also
name their engine.  ``chip_smoke.py``
holds the port's run on the card against them, ``tests/test_torch_golden.py``
regenerates and compares them.

    JAX_PLATFORMS=cpu python tests/data/make_torch_port_golden.py [NAME ...]
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).parent
NAMES = ("cifar10_bnn", "mnist_bnn", "mnist_tnn", "cifar10_bnn_int8",
         "cifar10_tnn_int8", "mnist_bnn_int8", "cifar10_tnn",
         "cifar10_tnn_a1", "cifar10_tnn_a3", "cifar10_bnn_zo_int8",
         "cifar10_tnn_tanh_int8", "cifar10_qnn_int8", "cifar10_qnn_relu_int8",
         "cifar10_tnn_tanh")
INT8 = "_int8"
# a golden's name (less the engine's suffix) -> (preset, the fields it
# changes)
VARIANTS = {"cifar10_tnn_a1": ("CIFAR10_TNN", dict(abits=1)),
            "cifar10_tnn_a3": ("CIFAR10_TNN", dict(abits=3,
                                                   last_layer_float=False)),
            "cifar10_bnn_zo": ("CIFAR10_BNN", dict(activation="binary_sigmoid")),
            "cifar10_tnn_tanh": ("CIFAR10_TNN", dict(activation="quantized_tanh")),
            "cifar10_qnn": ("CIFAR10_TNN", dict(network_type="full-qnn", wbits=4)),
            "cifar10_qnn_relu": ("CIFAR10_BNN", dict(network_type="qnn", wbits=4))}
VARIABLES_SEED = 0
IMAGES_SEED = 1
N_IMAGES = 8


def path(name: str) -> Path:
    return DATA / f"torch_port_golden_{name}.npz"


def config_of(name: str, module=None):
    """The config of a golden's name (``cifar10_bnn_int8`` -> CIFAR10_BNN,
    ``cifar10_tnn_a3`` -> CIFAR10_TNN at abits 3 with a quantized head),
    from ``module`` (the port's config module by default)."""
    if module is None:
        from qnx_torch.utils import config as module
    base = name.removesuffix(INT8)
    preset, changes = VARIANTS.get(base, (base.upper(), {}))
    return getattr(module, preset).replace(**changes)


def golden(name: str) -> dict:
    """Images and the JAX engine's logits (interpret-mode Pallas on CPU)."""
    from qnx.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                        pack_vgg_bitplane)
    from qnx.serve.engine import ServeEngine
    from qnx.utils import config
    from qnx_torch.models.factory import init_variables

    int8 = name.endswith(INT8)
    cf = config_of(name, config)
    if int8:
        pack = pack_int8
    elif cf.architecture == "mlp":
        pack = pack_mlp
    else:
        pack = pack_vgg_bitplane if cf.abits > 1 else pack_vgg
    images = np.random.default_rng(IMAGES_SEED).integers(
        0, 256, (N_IMAGES, *cf.input_shape), dtype=np.uint8)
    model = pack(init_variables(cf, VARIABLES_SEED), cf)
    with ServeEngine(model, batch_size=N_IMAGES) as engine:
        logits = engine.predict(images)
    out = {"variables_seed": np.int64(VARIABLES_SEED), "images": images,
           "logits": logits}
    if int8:
        out["engine"] = np.str_("int8")
    return out


def main(names=NAMES) -> None:
    for name in names:
        np.savez(path(name), **golden(name))
        print(f"wrote {path(name)}")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(sys.argv[1:] or NAMES)
