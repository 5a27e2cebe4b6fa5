"""Write the full-width goldens of the torch port: for each served config,
the logits that the JAX package's ``ServeEngine`` gives for 8 seeded uint8
images, with the random variables of
``qnx_torch.models.factory.init_variables(cf, seed=0)``:

* ``torch_port_golden_cifar10_bnn.npz``: the ``cifar10-bnn`` packed VGG;
* ``torch_port_golden_mnist_bnn.npz``: the ``mnist-bnn`` packed MLP;
* ``torch_port_golden_mnist_tnn.npz``: the ``mnist-tnn`` packed MLP;
* ``torch_port_golden_{cifar10_bnn,cifar10_tnn,mnist_bnn}_int8.npz``: the
  same configs through the int8 engine (``pack_int8``: pm1 codes, and level
  codes for ``cifar10-tnn``'s abits 2).

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
         "cifar10_tnn_int8", "mnist_bnn_int8")
INT8 = "_int8"
VARIABLES_SEED = 0
IMAGES_SEED = 1
N_IMAGES = 8


def path(name: str) -> Path:
    return DATA / f"torch_port_golden_{name}.npz"


def config_of(name: str):
    """The preset of a golden's name (``cifar10_bnn_int8`` -> CIFAR10_BNN)."""
    from qnx_torch.utils import config

    return getattr(config, name.removesuffix(INT8).upper())


def golden(name: str) -> dict:
    """Images and the JAX engine's logits (interpret-mode Pallas on CPU)."""
    from qnx.convert.pack_model import pack_int8, pack_mlp, pack_vgg
    from qnx.serve.engine import ServeEngine
    from qnx.utils import config
    from qnx_torch.models.factory import init_variables

    int8 = name.endswith(INT8)
    cf = getattr(config, name.removesuffix(INT8).upper())
    if int8:
        pack = pack_int8
    else:
        pack = pack_vgg if cf.architecture == "vgg" else pack_mlp
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
