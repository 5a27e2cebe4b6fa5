"""The qnx_torch bit-plane engine against the JAX package on the same numpy
inputs: kernel D's plain versions (plane GEMM, fused plane conv and dense)
and the popcount oracles against the JAX plane GEMM (Pallas in interpret
mode) and the JAX bit-plane layers, ``pack_vgg_bitplane``'s buffers against
the JAX converter's leaves, and ``PlaneVGG`` layer by layer and end to end.
Off the card every wrapper runs its kernel's plain version; the CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_test_utils import VGG_CF
from qnx.convert.pack_model import pack_vgg_bitplane as jax_pack_vgg_bitplane
from qnx.kernels import plane_gemm as jax_pg
from qnx.nn import inference as JI
from qnx.ops import reference as jax_reference
from qnx_torch.convert.pack_model import pack_vgg_bitplane
from qnx_torch.kernels import plane_gemm as PG
from qnx_torch.kernels.xnor_conv import pack_conv_ternary_np
from qnx_torch.models.factory import init_variables
from qnx_torch.nn.inference import PlaneDenseLogits, plane_forward
from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np
from qnx_torch.ops.reference import bitplane_gemm_ref
from qnx_torch.utils.config import CIFAR10_TNN

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)
# the JAX suite's bit-plane VGG (tests/test_bitplane.py:70), abits 2 and
# abits 3 with the integer head, and binary weights with 2-bit activations
TNN_CF = VGG_CF.replace(network_type="full-tnn", wbits=2, abits=2)
TNN_A3_CF = TNN_CF.replace(abits=3, last_layer_float=False)
BNN_A2_CF = VGG_CF.replace(abits=2)
PLANE_CFS = [TNN_CF, TNN_A3_CF, BNN_A2_CF]
PLANE_IDS = ["tnn-a2", "tnn-a3-int-head", "bnn-a2"]
# logits: equal planes feed the same float head; only the f32 summation
# order of the first conv and the head differ between XLA and torch
RTOL, ATOL_REL = 1e-5, 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _ternary(rng, shape):
    """{-1, 0, +1} weights, about half zero, one all-zero column."""
    w = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape,
                   p=[0.25, 0.5, 0.25])
    w[..., 1] = 0.0
    return w


def _weight_planes(w, axis=0):
    mask, sign, _ = pack_ternary_np(w, axis=axis)
    return mask, mask & sign


def _planes(rng, p, shape):
    """P packed {0,1} planes of random levels in [0, 2^P): (P, *shape[:-1], Cw)."""
    lvl = rng.integers(0, 2**p, shape)
    return np.stack([pack_bits_np((lvl >> j) & 1, axis=-1) for j in range(p)])


def _levels(rng, p, n, n_thresh, k):
    """Mixed-direction ascending thresholds around the spread of s, with
    int32-extreme channels (gamma == 0: constant levels)."""
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    sgn[1] = -1
    lim = 2 * int(np.sqrt(k)) * 2**p + 1
    tau = np.sort(rng.integers(-lim, lim, (n_thresh, n)), axis=0).astype(np.int32)
    tau[:, 0], tau[:, 1] = I32.min, I32.max
    tau[:, 2] = [I32.min] * (n_thresh - 1) + [I32.max]  # top level never
    return sgn, tau


@pytest.mark.parametrize("m,k,n", [(8, 32, 8), (5, 45, 9), (16, 288, 64)])
def test_plane_gemm_ref_matches_jax_plane_gemm(m, k, n):
    """One plane, the JAX suite's shapes (tests/test_bitplane.py:19), and
    the dense product it must equal."""
    rng = np.random.default_rng(m + k + n)
    b = (rng.random((m, k)) < 0.5).astype(np.float32)
    w = rng.integers(-1, 2, (k, n)).astype(np.float32)
    bp, (mask, msign) = pack_bits_np(b, -1), _weight_planes(w)
    want = np.asarray(jax_pg.plane_gemm(*_j(bp, mask, msign)))
    np.testing.assert_array_equal(want, (b @ w).astype(np.int32))
    for fn in (PG.plane_gemm, PG.plane_gemm_ref):
        got = fn(*_t(bp, mask, msign))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_plane_gemm_sums_planes_as_plane_dense_logits(p):
    """The multi-plane int32 s equals the JAX PlaneDenseLogits' plane sum of
    the JAX plane GEMM, and the port's head equals JAX's logits."""
    rng = np.random.default_rng(p)
    planes = _planes(rng, p, (9, 100))
    mask, msign = _weight_planes(_ternary(rng, (100, 10)))
    want = None
    for j in range(p):
        t = np.asarray(jax_pg.plane_gemm(*_j(planes[j], mask, msign)))
        want = t if want is None else want + (t << j)
    got = PG.plane_gemm(*_t(planes, mask, msign))
    np.testing.assert_array_equal(got.numpy(), want)
    a = rng.uniform(-0.1, 0.1, 10).astype(np.float32)
    c = rng.uniform(-1, 1, 10).astype(np.float32)
    head = PlaneDenseLogits(*_t(mask, msign, a, c))
    jlogits = jax.jit(lambda m, x: m(x))(
        JI.PlaneDenseLogits(*_j(mask, msign, a, c)), jnp.asarray(planes))
    np.testing.assert_array_equal(head(torch.from_numpy(planes)).numpy(),
                                  np.asarray(jlogits))


def test_bitplane_gemm_ref_matches_jax():
    rng = np.random.default_rng(0)
    planes = _planes(rng, 3, (6, 70))
    w = _ternary(rng, (70, 12))
    mask, sign, nnz = pack_ternary_np(w, axis=0)
    scales = np.array([0.25, 0.5, 1.0], np.float32)
    offset = rng.uniform(-1, 1, 12).astype(np.float32)
    want = jax_reference.bitplane_gemm_ref(*_j(planes, mask, sign, nnz, scales,
                                               offset))
    got = bitplane_gemm_ref(*_t(planes, mask, sign, nnz, scales, offset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [1, 3])
def test_plane_conv_oracle_matches_jax_plane_conv(p):
    rng = np.random.default_rng(10 + p)
    planes = _planes(rng, p, (2, 5, 6, 40))
    mask, sign, _ = pack_conv_ternary_np(_ternary(rng, (3, 3, 40, 16)))
    want = np.asarray(jax_pg.plane_conv(*_j(planes, mask, mask & sign)))
    got = PG.plane_conv(*_t(planes, mask, mask & sign))
    np.testing.assert_array_equal(got.numpy(), want)


def test_levels_to_planes_and_threshold_match_jax():
    rng = np.random.default_rng(1)
    lvl = rng.integers(0, 8, (3, 4, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        PG.levels_to_planes(torch.from_numpy(lvl), 3).numpy(),
        np.asarray(jax_pg.levels_to_planes(jnp.asarray(lvl), 3)))
    s = rng.integers(-50, 50, (3, 4, 40)).astype(np.int32)
    sgn, tau = _levels(rng, 2, 40, 3, 100)
    np.testing.assert_array_equal(
        PG.multi_threshold(*_t(s, sgn, tau)).numpy(),
        np.asarray(JI._multi_threshold(*_j(s, sgn, tau))))


CONV_CASES = [  # (p, n_thresh, b, h, w, c, n, pool)
    (1, 1, 2, 8, 8, 8, 8, False),
    (1, 1, 2, 8, 8, 8, 16, True),     # VGG_CF's conv_1
    (2, 3, 2, 4, 4, 16, 32, True),
    (2, 3, 1, 5, 7, 40, 48, False),   # odd spatial, N = 48
    (3, 7, 2, 4, 6, 32, 33, True),    # N = 33
    (3, 5, 1, 6, 4, 64, 10, False),   # N = 10
    (4, 15, 1, 4, 4, 8, 8, True),     # 15 thresholds
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[str(c) for c in CONV_CASES])
def test_plane_conv_fused_matches_jax_plane_conv_ternary(case):
    """The fused plane conv's planes equal the JAX layer's (plane GEMM,
    thresholds, pool of the levels, planes), with sgn = -1 channels and
    int32-extreme thresholds."""
    p, n_thresh, b, h, w, c, n, pool = case
    rng = np.random.default_rng(sum(case))
    planes = _planes(rng, p, (b, h, w, c))
    wgt = _ternary(rng, (3, 3, c, n))
    mask, sign, _ = pack_conv_ternary_np(wgt)
    msign = mask & sign
    sgn, tau = _levels(rng, p, n, n_thresh, 9 * c)
    layer = JI.PlaneConvTernary(*_j(mask, msign, sgn, tau), nb=p + 1, pool=pool)
    want = np.asarray(layer(jnp.asarray(planes)))
    got = PG.plane_conv_fused(*_t(planes, mask, msign, sgn, tau), pool=pool)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the int32-extreme channels 0, 1, 2 hold the levels n_thresh, 0 and
    # n_thresh - 1 everywhere
    level = [sum(((want[j][..., 0] >> ch) & 1) << j for j in range(p))
             for ch in range(3)]
    assert (level[0] == n_thresh).all() and (level[1] == 0).all()
    assert (level[2] == n_thresh - 1).all()


DENSE_CASES = [  # (p, n_thresh, m, k, n)
    (1, 1, 8, 64, 64),
    (2, 3, 5, 100, 48),
    (3, 7, 37, 96, 33),
    (3, 4, 4, 256, 10),
    (5, 31, 3, 64, 8),
]


@pytest.mark.parametrize("case", DENSE_CASES, ids=[str(c) for c in DENSE_CASES])
def test_plane_dense_fused_matches_jax_plane_dense_ternary(case):
    p, n_thresh, m, k, n = case
    rng = np.random.default_rng(sum(case))
    planes = _planes(rng, p, (m, k))
    mask, msign = _weight_planes(_ternary(rng, (k, n)))
    sgn, tau = _levels(rng, p, n, n_thresh, k)
    layer = JI.PlaneDenseTernary(*_j(mask, msign, sgn, tau), nb=p + 1)
    want = np.asarray(layer(jnp.asarray(planes)))
    got = PG.plane_dense_fused(*_t(planes, mask, msign, sgn, tau))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_never_count_launches():
    rng = np.random.default_rng(2)
    planes = _planes(rng, 2, (2, 4, 4, 32))
    mask, sign, _ = pack_conv_ternary_np(_ternary(rng, (3, 3, 32, 32)))
    sgn, tau = _levels(rng, 2, 32, 3, 288)
    for fn in (PG.plane_conv_fused, PG.plane_dense_fused, PG.plane_head):
        fn.launches = 0
    PG.plane_conv_fused(*_t(planes, mask, mask & sign, sgn, tau), pool=True)
    flat = torch.from_numpy(planes.reshape(2, 2, -1))
    dmask, dmsign = _weight_planes(_ternary(rng, (512, 32)))
    PG.plane_dense_fused(flat, *_t(dmask, dmsign, sgn, tau))
    PG.plane_gemm(flat, *_t(dmask, dmsign))
    assert (PG.plane_conv_fused.launches, PG.plane_dense_fused.launches,
            PG.plane_head.launches) == (0, 0, 0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(_planes(rng, 2, (4, 64)))
    mask, msign = _t(*_weight_planes(_ternary(rng, (64, 32))))
    sgn, tau = _t(*_levels(rng, 2, 32, 3, 64))
    with pytest.raises(ValueError, match="msign"):
        PG.plane_dense_fused(planes, mask[:1], msign, sgn, tau)
    with pytest.raises(ValueError, match="thresholds"):
        PG.plane_dense_fused(planes[:1], mask, msign, sgn, tau)
    with pytest.raises(ValueError, match="tau"):
        PG.plane_dense_fused(planes, mask, msign, sgn, tau[0])
    with pytest.raises(ValueError, match="planes"):
        PG.plane_gemm(planes.new_zeros(9, 4, 2), mask, msign)
    with pytest.raises(TypeError, match="int32"):
        PG.plane_gemm(planes.long(), mask, msign)
    conv = torch.from_numpy(_planes(rng, 2, (1, 5, 4, 32)))
    cmask, csign, _ = pack_conv_ternary_np(_ternary(rng, (3, 3, 32, 32)))
    cmask, cmsign = _t(cmask, cmask & csign)
    with pytest.raises(ValueError, match="even"):
        PG.plane_conv_fused(conv, cmask, cmsign, sgn, tau, pool=True)
    with pytest.raises(ValueError, match="must both be"):
        PG.plane_conv_fused(conv, cmask[:4], cmsign[:4], sgn, tau)


# ---------------------------------------------------------------- the model

def _jax_layers(jm):
    return [("first", jm.first), *[(f"convs.{i}", l) for i, l in enumerate(jm.convs)],
            *[(f"denses.{j}", l) for j, l in enumerate(jm.denses)],
            ("head", jm.head)]


@pytest.mark.parametrize("cf", [*PLANE_CFS, CIFAR10_TNN],
                         ids=[*PLANE_IDS, "cifar10-tnn"])
def test_pack_vgg_bitplane_buffers_equal_jax_leaves(cf):
    """Every leaf equal, the relu mode's corr (None), lvl0 (0) and mode
    included; the plane layers' nb and mode, which their input's plane
    count carries, are not held by the port, and JAX's must be their
    relu-mode values."""
    relu_only = {"corr": None, "lvl0": 0, "mode": "relu", "nb": cf.abits}
    variables = init_variables(cf, seed=3)
    jm = jax_pack_vgg_bitplane(variables, cf)
    tm = pack_vgg_bitplane(variables, cf, device="cpu")
    tlayers = dict(tm.named_modules())
    for name, jlayer in _jax_layers(jm):
        tlayer = tlayers[name]
        assert type(tlayer).__name__ == type(jlayer).__name__, name
        for f in dataclasses.fields(jlayer):
            want = getattr(jlayer, f.name)
            if not hasattr(tlayer, f.name):
                assert f.name in relu_only, f"{name}.{f.name}"
                assert want == relu_only[f.name], f"{name}.{f.name}"
                continue
            got = getattr(tlayer, f.name)
            if want is None or isinstance(want, (int, float, str, bool)):
                assert got == want, f"{name}.{f.name}"
            else:
                want = np.asarray(want)
                assert got.numpy().dtype == want.dtype, f"{name}.{f.name}"
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{name}.{f.name}")
    # the random BN draws reach both directions and both extremes
    for conv in tm.convs:
        assert (conv.sgn == -1).any() and (conv.sgn == 1).any()
        assert conv.tau.shape == (2 ** (cf.abits - 1) - 1, conv.sgn.shape[0])


@pytest.mark.parametrize("cf", PLANE_CFS, ids=PLANE_IDS)
def test_plane_layers_bit_exact_vs_jax(cf):
    """Fed the same input planes, every plane layer's planes (and the
    integer head's int32 s) equal JAX's; the levels span more than one
    value."""
    variables = init_variables(cf, seed=5)
    jm = jax_pack_vgg_bitplane(variables, cf)
    tm = pack_vgg_bitplane(variables, cf, device="cpu")
    x = np.random.default_rng(6).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    planes = jm.first(jnp.asarray(x))
    assert planes.shape[0] == cf.abits - 1
    with torch.inference_mode():
        for i, (jl, tl) in enumerate(zip(jm.convs, tm.convs)):
            want = jl(planes)
            got = tl(torch.tensor(np.asarray(planes)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"conv_{i + 1}")
            assert all(np.asarray(want[j]).any() for j in range(want.shape[0]))
            planes = want
        planes = planes.reshape(planes.shape[0], planes.shape[1], -1)
        for j, (jl, tl) in enumerate(zip(jm.denses, tm.denses)):
            want = jl(planes)
            got = tl(torch.tensor(np.asarray(planes)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"dense_{j}")
            planes = want
        tplanes = torch.tensor(np.asarray(planes))
        if isinstance(jm.head, JI.PlaneDenseLogits):  # the head's int32 s
            s = None
            for j in range(planes.shape[0]):
                t = np.asarray(jax_pg.plane_gemm(planes[j], jm.head.mask,
                                                 jm.head.msign))
                s = t if s is None else s + (t << j)
            np.testing.assert_array_equal(tm.head.scores(tplanes).numpy(), s)
        np.testing.assert_allclose(tm.head(tplanes).numpy(),
                                   np.asarray(jm.head(planes)), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("cf", PLANE_CFS, ids=PLANE_IDS)
def test_first_layer_planes_match_jax(cf):
    """The float first conv's levels: equal but where the BN output is
    within rounding of a level boundary (XLA and torch sum the f32 conv in
    different orders)."""
    variables = init_variables(cf, seed=7)
    jm = jax_pack_vgg_bitplane(variables, cf)
    tm = pack_vgg_bitplane(variables, cf, device="cpu")
    x = np.random.default_rng(8).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.first(jnp.asarray(x)))
    with torch.inference_mode():
        got = tm.first(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    differ = np.unpackbits(np.bitwise_xor(got, want).view(np.uint8)).mean()
    assert differ <= 1e-4


@pytest.mark.parametrize("cf", PLANE_CFS, ids=PLANE_IDS)
def test_logits_match_jax_plane_vgg(cf):
    variables = init_variables(cf, seed=8)
    x = np.random.default_rng(9).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    jm = jax_pack_vgg_bitplane(variables, cf)
    want = np.asarray(jax.jit(lambda m, v: m(v))(jm, jnp.asarray(x)))
    got = plane_forward(pack_vgg_bitplane(variables, cf, device="cpu"),
                        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_unported_bitplane_variants_raise():
    """quantized_tanh, which raised before the port lowered it, gives the
    JAX PlaneVGG's logits (nb planes, the border term, lvl0); abits 1
    still raises ValueError."""
    cf = TNN_CF.replace(activation="quantized_tanh")
    variables = init_variables(cf, seed=0)
    tm = pack_vgg_bitplane(variables, cf, device="cpu")
    assert tm.first.mode == "tanh" and tm.head.lvl0 == 1
    assert all(conv.corr is not None for conv in tm.convs)
    x = np.random.default_rng(1).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda m, v: m(v))(
        jax_pack_vgg_bitplane(variables, cf), jnp.asarray(x)))
    got = plane_forward(tm, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    with pytest.raises(ValueError, match="abits"):
        pack_vgg_bitplane(init_variables(VGG_CF, seed=0), VGG_CF, device="cpu")
