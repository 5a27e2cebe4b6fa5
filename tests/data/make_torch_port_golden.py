"""Write ``torch_port_golden_cifar10_bnn.npz``: the logits that the JAX
package's ``ServeEngine`` gives for 8 seeded uint8 images through the
full-width ``cifar10-bnn`` packed VGG, with the random variables of
``qnx_torch.models.factory.init_variables(CIFAR10_BNN, seed=0)``.
``chip_smoke.py`` holds the port's run on the card against it,
``tests/test_torch_golden.py`` regenerates and compares it.

    JAX_PLATFORMS=cpu python tests/data/make_torch_port_golden.py
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
GOLDEN = Path(__file__).with_name("torch_port_golden_cifar10_bnn.npz")
VARIABLES_SEED = 0
IMAGES_SEED = 1
N_IMAGES = 8


def golden() -> dict:
    """Images and the JAX engine's logits (interpret-mode Pallas on CPU)."""
    from qnx.convert.pack_model import pack_vgg
    from qnx.serve.engine import ServeEngine
    from qnx.utils.config import CIFAR10_BNN
    from qnx_torch.models.factory import init_variables

    images = np.random.default_rng(IMAGES_SEED).integers(
        0, 256, (N_IMAGES, *CIFAR10_BNN.input_shape), dtype=np.uint8)
    model = pack_vgg(init_variables(CIFAR10_BNN, VARIABLES_SEED), CIFAR10_BNN)
    with ServeEngine(model, batch_size=N_IMAGES) as engine:
        logits = engine.predict(images)
    return {"variables_seed": np.int64(VARIABLES_SEED), "images": images,
            "logits": logits}


def main() -> None:
    np.savez(GOLDEN, **golden())
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
