"""qnx_torch's integer logit heads (``csrc/popcount_head.cu``: the binary
head of kernel B, ``xnor_head``; the ternary head of kernel C,
``ternary_head``; D's bit-plane head, ``plane_head``) against the JAX
package on the same numpy operands.

On CPU tensors each wrapper runs its plain version (the popcount GEMM's
plain version, then the float64 affine rounded once); here those give the
int32 s of the JAX Pallas kernels in interpret mode (``xnor_gemm_popcount``,
``ternary_gemm``, ``plane_gemm`` summed over the planes) exactly and the
logits of the jitted JAX heads bit for bit.  A numpy mirror of the CUDA
kernel's geometry (a warp a row and 16 columns, the words split over 32
lanes, the lanes summed, the planes summed in the same warp, int32 all the
way) equals the unsplit sum.  The CUDA kernel itself is held against the
plain versions on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.kernels import plane_gemm as jax_pg
from qnx.kernels.ternary_gemm import ternary_gemm as jax_ternary_gemm
from qnx.kernels.xnor_gemm import xnor_gemm_popcount as jax_xnor_gemm_popcount
from qnx.nn import inference as JI
from qnx_torch.kernels import plane_gemm as PG
from qnx_torch.kernels import ternary_gemm as T
from qnx_torch.kernels import xnor_gemm as X
from qnx_torch.nn import inference as TI
from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)
# (m, k, n): the heads' N = 10 with M = 1 and 257 (a second row block), N =
# 1 and 33 (a third column group of 16), K not a multiple of 32 and Kw not
# a multiple of the 32 lanes (35 words)
SHAPES = [(1, 100, 10), (7, 1100, 10), (257, 96, 10), (5, 100, 1),
          (3, 1000, 33), (16, 256, 17)]
IDS = [f"m{m}k{k}n{n}" for m, k, n in SHAPES]
PLANES = [1, 2, 3, 8]
# the kernel's geometry (popcount_head.cu)
LANES, COLS = 32, 16


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _affine_operands(rng, n):
    """The folded affine of a head: a of both signs with zeros, c anywhere."""
    a = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    a[::4] = 0.0
    return a, rng.uniform(-2, 2, n).astype(np.float32)


def _binary(m, k, n, seed=0):
    rng = np.random.default_rng(seed + m * 1000 + k + n)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = np.where(rng.random((k, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    return pack_bits_np(x, -1), pack_bits_np(w, 0), *_affine_operands(rng, n)


def _ternary(m, k, n, bump_nnz, seed=1):
    """±1 activations, {-1, 0, +1} weights (one all-zero column), and nnz as
    counted or bumped away from the count."""
    rng = np.random.default_rng(seed + m * 1000 + k + n)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (k, n))
    w[:, 0] = 0.0
    mask, sign, nnz = pack_ternary_np(w, axis=0)
    if bump_nnz:
        nnz = (nnz + rng.integers(-5, 6, n)).astype(np.int32)
    return pack_bits_np(x, -1), mask, sign, nnz, *_affine_operands(rng, n)


def _planes(m, k, n, p, msign_outside, seed=2):
    """P packed {0,1} planes of levels in [0, 2^P), ternary weight planes
    (msign = mask & sign, or sign itself: bits outside the mask)."""
    rng = np.random.default_rng(seed + p * 100 + m * 1000 + k + n)
    lvl = rng.integers(0, 2**p, (m, k))
    planes = np.stack([pack_bits_np((lvl >> j) & 1, axis=-1) for j in range(p)])
    w = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (k, n))
    mask, sign, _ = pack_ternary_np(w, axis=0)
    msign = sign if msign_outside else mask & sign
    return planes, mask, msign, *_affine_operands(rng, n)


def _jit_head(head, x):
    return np.asarray(jax.jit(lambda h, v: h(v))(head, jnp.asarray(x)))


@pytest.mark.parametrize("m,k,n", SHAPES, ids=IDS)
def test_xnor_head_matches_jax(m, k, n):
    xp, wp, a, c = _binary(m, k, n)
    s = np.asarray(jax_xnor_gemm_popcount(*_j(xp, wp), k))
    got = X.xnor_head(*_t(xp, wp), k)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), s)
    want = _jit_head(JI.PackedDenseLogits(*_j(wp, a, c), k=k), xp)
    logits = X.xnor_head(*_t(xp, wp), k, *_t(a, c))
    assert logits.dtype == torch.float32
    np.testing.assert_array_equal(logits.numpy(), want)
    head = TI.PackedDenseLogits(*_t(wp, a, c), k)
    np.testing.assert_array_equal(head.scores(torch.from_numpy(xp)).numpy(), s)
    np.testing.assert_array_equal(head(torch.from_numpy(xp)).numpy(), want)


@pytest.mark.parametrize("bump_nnz", [False, True], ids=["nnz", "nnz-bumped"])
@pytest.mark.parametrize("m,k,n", SHAPES, ids=IDS)
def test_ternary_head_matches_jax(m, k, n, bump_nnz):
    """nnz is the base whatever it holds: bumped away from the mask's count,
    the JAX kernel and the port still agree."""
    xp, mask, sign, nnz, a, c = _ternary(m, k, n, bump_nnz)
    s = np.asarray(jax_ternary_gemm(*_j(xp, mask, sign, nnz)))
    np.testing.assert_array_equal(
        T.ternary_head(*_t(xp, mask, sign, nnz)).numpy(), s)
    want = _jit_head(JI.TernaryDenseLogits(*_j(mask, sign, nnz, a, c)), xp)
    np.testing.assert_array_equal(
        T.ternary_head(*_t(xp, mask, sign, nnz, a, c)).numpy(), want)
    head = TI.TernaryDenseLogits(*_t(mask, sign, nnz, a, c))
    np.testing.assert_array_equal(head.scores(torch.from_numpy(xp)).numpy(), s)
    np.testing.assert_array_equal(head(torch.from_numpy(xp)).numpy(), want)


@pytest.mark.parametrize("msign_outside", [False, True], ids=["msign", "outside"])
@pytest.mark.parametrize("p", PLANES)
@pytest.mark.parametrize("m,k,n", [(1, 100, 10), (257, 96, 10), (3, 1100, 33)],
                         ids=["m1k100n10", "m257k96n10", "m3k1100n33"])
def test_plane_head_matches_jax(m, k, n, p, msign_outside):
    """s = sum_j 2^j t_j, the JAX plane_gemm per plane shifted and summed as
    the JAX PlaneDenseLogits does, and its jitted logits; msign bits
    outside the mask count as weight 2 in both."""
    planes, mask, msign, a, c = _planes(m, k, n, p, msign_outside)
    s = None
    for j in range(p):
        t = np.asarray(jax_pg.plane_gemm(*_j(planes[j], mask, msign)))
        s = t if s is None else s + (t << j)
    np.testing.assert_array_equal(
        PG.plane_head(*_t(planes, mask, msign)).numpy(), s)
    np.testing.assert_array_equal(PG.plane_gemm(*_t(planes, mask, msign)).numpy(), s)
    want = _jit_head(JI.PlaneDenseLogits(*_j(mask, msign, a, c)), planes)
    np.testing.assert_array_equal(
        PG.plane_head(*_t(planes, mask, msign, a, c)).numpy(), want)
    head = TI.PlaneDenseLogits(*_t(mask, msign, a, c))
    np.testing.assert_array_equal(head.scores(torch.from_numpy(planes)).numpy(), s)
    np.testing.assert_array_equal(head(torch.from_numpy(planes)).numpy(), want)


def test_one_plane_takes_a_2d_input():
    planes, mask, msign, a, c = _planes(6, 200, 10, 1, False)
    np.testing.assert_array_equal(
        PG.plane_head(*_t(planes[0], mask, msign, a, c)).numpy(),
        PG.plane_head(*_t(planes, mask, msign, a, c)).numpy())


# ------------------------------------------------------- the kernel's geometry

def _word_terms(kind, x, wt, p):
    """Per (row, column, word) term of the head's sum, int64: x (P, M, Kw),
    wt (planes, N, Kw) uint32 words."""
    pc = lambda v: np.bitwise_count(v).astype(np.int64)
    if kind == "xnor":
        return pc(x[0][:, None, :] ^ wt[0][None])
    if kind == "ternary":
        return pc(wt[0][None] & (x[0][:, None, :] ^ wt[1][None]))
    terms = 0
    for j in range(p):
        b = x[j][:, None, :]
        terms = terms + (2 * pc(b & wt[1][None]) - pc(b & wt[0][None])) * 2**j
    return terms


def _mirror(kind, x, wt, p, base, scale):
    """The CUDA kernel's geometry in numpy: warp task t covers row t //
    groups and columns (t % groups) * 16 .. + 16; lane l sums words l, l +
    32, ... in int32; the lanes' sums are reduced in int32; lane g stores
    column col0 + g as base + scale * total.  Returns the (M, N) s and the
    lane that stored each output."""
    _, m, kw = x.shape
    n = wt.shape[1]
    terms = _word_terms(kind, x, wt, p)
    steps = -(-kw // LANES)
    padded = np.zeros((m, n, steps * LANES), np.int64)
    padded[..., :kw] = terms
    lanes = padded.reshape(m, n, steps, LANES).sum(axis=2)  # (M, N, 32)
    assert np.abs(lanes).max(initial=0) <= I32.max
    lanes = lanes.astype(np.int32)
    groups = -(-n // COLS)
    s = np.full((m, n), I32.min, np.int64)
    lane_of = np.full((m, n), -1)
    for task in range(m * groups):
        row, col0 = task // groups, task % groups * COLS
        for g in range(COLS):
            col = col0 + g
            if col >= n:
                continue
            total = lanes[row, col].sum(dtype=np.int32)
            assert s[row, col] == I32.min, "an output stored twice"
            s[row, col] = base[col] + scale * int(total)
            lane_of[row, col] = g
    assert (lane_of >= 0).all(), "an output never stored"
    return s, lane_of


def _k_major(*planes):
    return np.stack([p.T for p in planes]).astype(np.uint32)


@pytest.mark.parametrize("kind", ["xnor", "ternary", "plane"])
@pytest.mark.parametrize("m,k,n", [(3, 100, 1), (4, 4096, 10), (2, 1100, 33),
                                   (5, 32, 16), (1, 9000, 17)])
def test_lane_split_mirror_equals_unsplit_sum(kind, m, k, n):
    if kind == "xnor":
        xp, wp, _, _ = _binary(m, k, n)
        x, wt, p = xp[None].view(np.uint32), _k_major(wp), 1
        base, scale, want = np.full(n, k), -2, X.xnor_gemm_popcount_ref(*_t(xp, wp), k)
    elif kind == "ternary":
        xp, mask, sign, nnz, _, _ = _ternary(m, k, n, bump_nnz=True)
        x, wt, p = xp[None].view(np.uint32), _k_major(mask, sign), 1
        base, scale = nnz, -2
        want = T.ternary_gemm_ref(*_t(xp, mask, sign, nnz))
    else:
        p = 3
        planes, mask, msign, _, _ = _planes(m, k, n, p, msign_outside=True)
        x, wt = planes.view(np.uint32), _k_major(mask, msign)
        base, scale, want = np.zeros(n, np.int64), 1, PG.plane_gemm_ref(*_t(planes, mask, msign))
    s, lane_of = _mirror(kind, x, wt, p, base, scale)
    np.testing.assert_array_equal(s, want.numpy())
    np.testing.assert_array_equal(lane_of, np.broadcast_to(np.arange(n) % COLS, (m, n)))


def test_int32_extreme_of_eight_planes():
    """|s| = K (2^P - 1), all levels 255 against all weights +1, just below
    2^31 at P = 8: every lane's and the warp's int32 sum holds it, and the
    wrappers refuse one word more than fits."""
    p, kw = 8, (2**31 - 1) // (32 * 255)
    x = np.full((p, 1, kw), 0xFFFFFFFF, np.uint32)
    wt = np.full((2, 1, kw), 0xFFFFFFFF, np.uint32)  # mask and msign: +1
    s, _ = _mirror("plane", x, wt, p, np.zeros(1, np.int64), 1)
    assert s[0, 0] == 32 * kw * 255 <= I32.max
    ones = torch.zeros((p, 1, kw + 1), dtype=torch.int32)
    w = torch.zeros((kw + 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        PG.plane_head(ones, w, w)


# ------------------------------------------------------------- the wrappers

def test_heads_hold_their_weights_k_major():
    xp, wp, a, c = _binary(4, 100, 10)
    head = TI.PackedDenseLogits(*_t(wp, a, c), 100)
    np.testing.assert_array_equal(head.wt.numpy(), wp.T[None])
    _, mask, sign, nnz, a, c = _ternary(4, 100, 10, False)
    head = TI.TernaryDenseLogits(*_t(mask, sign, nnz, a, c))
    np.testing.assert_array_equal(head.wt.numpy(), np.stack([mask.T, sign.T]))
    assert head.wt.is_contiguous() and "wt" in dict(head.named_buffers())
    np.testing.assert_array_equal(X.k_major(*_t(mask, sign)).numpy(),
                                  np.stack([mask.T, sign.T]))


def test_cpu_tensors_never_count_launches():
    fns = (X.xnor_head, T.ternary_head, PG.plane_head)
    for fn in fns:
        fn.launches = 0
    xp, wp, a, c = _binary(4, 64, 10)
    X.xnor_head(*_t(xp, wp), 64, *_t(a, c))
    xp, mask, sign, nnz, a, c = _ternary(4, 64, 10, False)
    T.ternary_head(*_t(xp, mask, sign, nnz))
    planes, mask, msign, a, c = _planes(4, 64, 10, 2, False)
    PG.plane_head(*_t(planes, mask, msign, a, c))
    TI.PlaneDenseLogits(*_t(mask, msign, a, c))(torch.from_numpy(planes))
    assert [fn.launches for fn in fns] == [0, 0, 0]


def test_head_wrappers_reject_what_the_kernel_does_not_take():
    xp, wp, a, c = _binary(4, 64, 10)
    xp, wp, a, c = _t(xp, wp, a, c)
    with pytest.raises(ValueError, match="both a and c"):
        X.xnor_head(xp, wp, 64, a)
    with pytest.raises(ValueError, match="must be \\(10,\\)"):
        X.xnor_head(xp, wp, 64, a[:5], c)
    with pytest.raises(TypeError, match="float32"):
        X.xnor_head(xp, wp, 64, a.double(), c)
    with pytest.raises(ValueError, match="k_major"):
        X.xnor_head(xp, wp, 64, a, c, wt=wp.t().contiguous())
    with pytest.raises(ValueError, match="Kw"):
        X.xnor_head(xp, wp[:1], 64)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        X.xnor_head(xp.to("meta"), wp.to("meta"), 64)
    _, mask, sign, nnz, _, _ = _ternary(4, 64, 10, False)
    with pytest.raises(ValueError, match="nnz"):
        T.ternary_head(xp, *_t(mask, sign, nnz[:5]))
    with pytest.raises(ValueError, match="contiguous"):
        T.ternary_head(xp, *_t(mask, sign), torch.from_numpy(nnz).repeat(2)[::2])
    planes, mask, msign, _, _ = _planes(4, 64, 10, 2, False)
    with pytest.raises(ValueError, match="planes"):
        PG.plane_head(torch.zeros((9, 4, 2), dtype=torch.int32), *_t(mask, msign))
    with pytest.raises(ValueError, match="wt"):
        PG.plane_head(*_t(planes, mask, msign), a, c,
                      wt=X.k_major(*_t(mask)))
