"""The tensor-core rate probe (:mod:`qnx_torch.bench.tc_probe`,
``kernels/csrc/tc_probe.cu``) on the CPU: its plain version against numpy
(the AND-popcount of 256-bit rows and the int8 dot of 32-byte rows, times
the iterations, wrapped to int32), the wrapper's CPU route and checks, and
the MAC count its rates divide by.  The kernel itself is held against the
plain version on the card (``measure``, run by ``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

from qnx_torch.bench import tc_probe as T

torch.set_num_threads(2)


def _numpy_product(a, b, mode):
    if mode == "b1":
        au, bu = a.view(np.uint32), b.view(np.uint32)
        return np.bitwise_count(au[:, None, :] & bu[None, :, :]).sum(-1).astype(np.int64)
    a8, b8 = a.view(np.int8).astype(np.int64), b.view(np.int8).astype(np.int64)
    return a8 @ b8.T


@pytest.mark.parametrize("mode", list(T.MODES))
@pytest.mark.parametrize("iters", [0, 1, 3, 2**20 + 7])
def test_plain_version_matches_numpy(mode, iters):
    rng = np.random.default_rng(iters)
    a = rng.integers(-2**31, 2**31, (T.ROWS_A, T.WORDS), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (T.ROWS_B, T.WORDS), dtype=np.int64).astype(np.int32)
    want = (_numpy_product(a, b, mode) * iters) & 0xFFFFFFFF  # wraps as int32
    want = want.astype(np.uint32).view(np.int32)
    got = T.tc_probe_ref(torch.from_numpy(a), torch.from_numpy(b), mode, iters, blocks=2)
    assert got.dtype == torch.int32 and got.shape == (2 * T.WARPGROUPS, T.ROWS_A, T.ROWS_B)
    for w in range(got.shape[0]):  # every warpgroup computes the whole product
        np.testing.assert_array_equal(got[w].numpy(), want)


def test_cpu_route_runs_the_plain_version_and_counts_no_launch():
    a, b = T.operands("cpu")
    T.tc_probe.launches = 0
    for mode in T.MODES:
        assert torch.equal(T.tc_probe(a, b, mode, 5, 3), T.tc_probe_ref(a, b, mode, 5, 3))
    assert T.tc_probe.launches == 0
    # the measured operands keep every s8 sum far from wrapping
    s8 = T.tc_probe_ref(a, b, "s8", 1).abs().max().item()
    assert s8 * 4 * 8192 < 2**31


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = T.operands("cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        T.tc_probe(a, b, "u8", 1)
    with pytest.raises(ValueError, match="must be"):
        T.tc_probe(a[:32], b, "b1", 1)
    with pytest.raises(ValueError, match="iters"):
        T.tc_probe(a, b, "b1", -1)
    with pytest.raises(ValueError, match="blocks"):
        T.tc_probe(a, b, "b1", 1, blocks=0)
    with pytest.raises(TypeError, match="int32"):
        T.tc_probe(a.to(torch.int64), b, "b1", 1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        T.tc_probe(a.to("meta"), b.to("meta"), "b1", 1)


def test_macs_of_a_launch():
    # per warpgroup and iteration: four wgmma of 64 x 128 x 256 bits (b1) or
    # 64 x 128 x 32 bytes (s8), the same bytes
    assert T.macs("b1", 1, 1) == 2 * 4 * 64 * 128 * 256
    assert T.macs("s8", 1, 1) * 8 == T.macs("b1", 1, 1)
    assert T.macs("b1", 10, 264) == 10 * 264 * T.macs("b1", 1, 1)


def test_measure_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.main()
    with pytest.raises(RuntimeError, match="no CPU route"):
        T.measure(device="cpu")
