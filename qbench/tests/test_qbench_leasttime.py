"""The least-time arithmetic at the configurations' shapes."""
import pytest

from qbench import registry
from qbench.leasttime import PEAKS, least_s

ARCH = registry.architecture("binarynet_vgg")
BNN = registry._json(registry.HERE / "configs" / "cifar10-bnn-int8.json")
TNN = registry._json(registry.HERE / "configs" / "cifar10-tnn-bitplane.json")


def _macs(spec, stage):
    return sum(r["macs"] for r in ARCH.layer_work(spec) if r["stage"] == stage)


@pytest.mark.parametrize("spec", [BNN, TNN], ids=["bnn", "tnn"])
def test_macs_per_image(spec):
    assert _macs(spec, "first") == 3_538_944
    assert _macs(spec, "convs") == 603_979_776
    assert _macs(spec, "denses") == 9_437_184
    assert _macs(spec, "head") == 10_240


def test_units():
    assert ARCH.activation_planes(BNN) == 1 and ARCH.activation_planes(TNN) == 2
    bnn = {r["name"]: r for r in ARCH.layer_work(BNN)}
    tnn = {r["name"]: r for r in ARCH.layer_work(TNN)}
    assert bnn["conv_0"]["unit"] == "f32" and bnn["dense_out"]["unit"] == "f32"
    assert bnn["conv_3"]["b1_per_mac"] == 1   # binary x binary: one AND-popcount MAC
    assert tnn["conv_3"]["b1_per_mac"] == 4   # ternary weights x two planes


def test_least_times_at_batch_1024():
    b = 1024
    # conv_0: 2 FLOP a MAC at 67 TFLOP/s
    assert least_s(ARCH.layer_work(BNN), b, "first") / b == pytest.approx(
        2 * 3_538_944 / PEAKS["f32_flops"])
    assert least_s(ARCH.layer_work(BNN), b, "convs") / b == pytest.approx(
        603_979_776 / PEAKS["b1_macs"])
    assert least_s(ARCH.layer_work(TNN), b, "convs") / b == pytest.approx(
        4 * 603_979_776 / PEAKS["b1_macs"])
    assert least_s(ARCH.layer_work(BNN), b) / b == pytest.approx(1.835e-7, rel=0.01)
    assert least_s(ARCH.layer_work(TNN), b) / b == pytest.approx(4.16e-7, rel=0.01)


def test_bytes_bind_at_batch_one():
    rows = ARCH.layer_work(BNN)
    dense0 = [r for r in rows if r["name"] == "dense_0"]
    assert least_s(dense0, 1) == pytest.approx(
        (dense0[0]["io_bytes"] + 8192 * 1024 / 8) / PEAKS["hbm_bytes"])
