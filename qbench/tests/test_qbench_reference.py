"""The plain reference against the port's CPU path, and the control against
the reference.  The reference imports nothing of the program."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from qbench import checks, registry
from qbench.run import program_config

ARCH = registry.architecture("binarynet_vgg")
CONFIGS = ["cifar10-bnn-int8", "cifar10-tnn-bitplane"]


def _spec(name, **kw):
    return {**registry._json(registry.HERE / "configs" / f"{name}.json"), **kw}


def _port_logits(spec, variables, images):
    from qnx_torch.convert import pack_model
    from qnx_torch.serve.engine import normalize_u8

    model = getattr(pack_model, spec["packer"])(variables, program_config(spec),
                                                device="cpu")
    with torch.inference_mode():
        return model(normalize_u8(torch.from_numpy(images))).numpy()


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def test_reference_imports_nothing_of_the_program():
    src = Path(ARCH.__file__).read_text()
    names = {a.name.split(".")[0] for n in ast.walk(ast.parse(src))
             if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in (n.names if isinstance(n, ast.Import)
                       else [ast.alias(n.module or "")])}
    assert names <= {"__future__", "math", "contextlib", "numpy", "torch"}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_reference_equals_the_port_at_a_small_width(name, seed):
    spec = _spec(name, width=16, dense_units=32)
    variables = ARCH.make_variables(spec, seed, "cpu")
    images = _images(32, seed)
    ref = ARCH.reference_logits(spec, variables, torch.from_numpy(images)).numpy()
    port = _port_logits(spec, variables, images)
    assert not checks.mismatched(port, ref).any()
    assert np.abs(port - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("name", CONFIGS)
def test_the_control_is_not_correct_at_full_width(name):
    """The reference in TF32 disagrees with it on most images, so that the
    configuration's limits judge it not correct, where the port (float32)
    agrees on every one."""
    spec = _spec(name)
    seed = 2**31 + 77
    variables = ARCH.make_variables(spec, seed, "cpu")
    images = _images(16, seed)
    x = torch.from_numpy(images)
    ref = ARCH.reference_logits(spec, variables, x, "exact").numpy()
    ctl = ARCH.reference_logits(spec, variables, x, "tf32").numpy()
    assert checks.mismatched(ctl, ref).mean() > 0.5
    readings = {"unanswered": 0, "checked_images": len(images)}
    correct, _ = checks.judge({**readings, "logit_mismatch_share": float(
        checks.mismatched(ctl, ref).mean())}, spec["limits"])
    assert correct is False
    port = float(checks.mismatched(_port_logits(spec, variables, images), ref).mean())
    assert port == 0.0
    assert checks.judge({**readings, "logit_mismatch_share": port}, spec["limits"])[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_every_hidden_layer_takes_both_codes(name):
    """The seeded BatchNorm statistics keep every hidden layer's codes
    varied at the published widths."""
    from qnx_torch.convert import pack_model
    from qnx_torch.serve.engine import normalize_u8

    spec = _spec(name)
    variables = ARCH.make_variables(spec, 5, "cpu")
    model = getattr(pack_model, spec["packer"])(variables, program_config(spec), device="cpu")
    with torch.inference_mode():
        a = model.first(normalize_u8(torch.from_numpy(_images(8, 5))))
        layers = [a]
        for conv in model.convs:
            a = conv(a)
            layers.append(a)
    for out in layers:
        assert torch.unique(out).numel() >= 2


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0000002])
    y = ARCH._tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0]
