"""The STE ops of ``qnx_torch.ops.quant`` against ``qnx.ops.quant`` on the
same numpy inputs: forward values bit for bit, and gradients
(``torch.autograd.grad`` against ``jax.grad``) exactly equal at the
boundaries (±1, 0, ±H, ±0.5 H and their float32 neighbours) and on random
points; the cases of ``tests/test_quant_ops.py`` and the stochastic
binarization of ``tests/test_misc_features.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.ops import quant as JQ
from qnx_torch.ops import quant as TQ

torch.set_num_threads(2)

H = 0.3  # a weight scale that is not a power of two


def _points(h: float) -> np.ndarray:
    """The boundaries of every op at scale h, their float32 neighbours, the
    cases of tests/test_quant_ops.py, and random points."""
    edges = np.float32([0.0, 1.0, -1.0, h, -h, 0.5 * h, -0.5 * h, 0.5, -0.5,
                        1.5, -1.5, 2.5, 0.49, 0.51, 1e-6, -1e-6, 0.1, -0.1,
                        2.0, -2.0, 0.7, -0.7, 0.25, 0.75, 0.125])
    near = np.concatenate([np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))])
    # 0's neighbours are subnormal, which XLA:CPU flushes to zero and torch
    # does not: take the smallest normal floats instead
    tiny = np.finfo(np.float32).tiny
    near = np.where(np.abs(near) < tiny, np.sign(near) * tiny, near)
    rnd = np.random.default_rng(0).uniform(-2.5, 2.5, 200).astype(np.float32)
    return np.concatenate([edges, near, rnd]).astype(np.float32)


# (name, jax function, torch function) of x; H passed as in each package
OPS = [
    ("round_through", JQ.round_through, TQ.round_through),
    ("clip_through", lambda x: JQ.clip_through(x, -0.6, 0.8),
     lambda x: TQ.clip_through(x, -0.6, 0.8)),
    ("hard_sigmoid", JQ.hard_sigmoid, TQ.hard_sigmoid),
    ("binary_sigmoid", JQ.binary_sigmoid, TQ.binary_sigmoid),
    ("binary_tanh", JQ.binary_tanh, TQ.binary_tanh),
    ("binarize", lambda x: JQ.binarize(x, H), lambda x: TQ.binarize(x, H)),
    ("binarize_h1", JQ.binarize, TQ.binarize),
    ("ternarize", lambda x: JQ.ternarize(x, H), lambda x: TQ.ternarize(x, H)),
    ("ternarize_h1", JQ.ternarize, TQ.ternarize),
    ("quantize_nb2", lambda x: JQ.quantize(x, 2), lambda x: TQ.quantize(x, 2)),
    ("quantize_nb4_h", lambda x: JQ.quantize(x, 4, H),
     lambda x: TQ.quantize(x, 4, H)),
    ("quantized_relu_nb2", lambda x: JQ.quantized_relu(x, 2),
     lambda x: TQ.quantized_relu(x, 2)),
    ("quantized_relu_nb3", lambda x: JQ.quantized_relu(x, 3),
     lambda x: TQ.quantized_relu(x, 3)),
    ("quantized_tanh_nb2", lambda x: JQ.quantized_tanh(x, 2),
     lambda x: TQ.quantized_tanh(x, 2)),
    ("quantized_tanh_nb3", lambda x: JQ.quantized_tanh(x, 3),
     lambda x: TQ.quantized_tanh(x, 3)),
    ("clip_weights", lambda x: JQ.clip_weights(x, H),
     lambda x: TQ.clip_weights(x, H)),
]
OP_IDS = [name for name, *_ in OPS]


def _grad_torch(fn, x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(x.copy()).requires_grad_()
    (g,) = torch.autograd.grad(fn(t).sum(), t)
    return g.numpy()


def _grad_jax(fn, x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.vmap(jax.grad(fn))(jnp.asarray(x)))


@pytest.mark.parametrize("name,jfn,tfn", OPS, ids=OP_IDS)
def test_forward_bit_for_bit(name, jfn, tfn):
    x = _points(H)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name,jfn,tfn", OPS[:-1], ids=OP_IDS[:-1])
def test_gradient_equal(name, jfn, tfn):
    x = _points(H)
    np.testing.assert_array_equal(_grad_torch(tfn, x), _grad_jax(jfn, x))


@pytest.mark.parametrize("h", [H, 1.0])
def test_h_as_device_tensor_equals_h_as_float(h):
    """The layers pass H as their 0-d float32 buffer; the values and the
    gradients are those of the Python float."""
    x = _points(h)
    ht = torch.tensor(h, dtype=torch.float32)
    for op in (TQ.binarize, TQ.ternarize, lambda w, hh: TQ.quantize(w, 4, hh),
               TQ.clip_weights):
        a = op(torch.from_numpy(x), h).numpy()
        b = op(torch.from_numpy(x), ht).numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        np.testing.assert_array_equal(_grad_torch(lambda t: op(t, h), x),
                                      _grad_torch(lambda t: op(t, ht), x))


def test_hard_sigmoid_gradient_inclusive_at_one():
    """0.5 at exactly ±1 (the JAX custom JVP), not clamp's 0.25 or 0."""
    g = _grad_torch(TQ.hard_sigmoid, np.float32([-1.0, 1.0, -1.0000001, 1.0000001]))
    np.testing.assert_array_equal(g, [0.5, 0.5, 0.0, 0.0])


def test_binary_tanh_tie_contract():
    """round half to even: binary_tanh(0) = -1; +1 iff x > 0."""
    x = torch.tensor([-2.0, -0.1, 0.0, 0.1, 2.0, 1e-6, -1e-6])
    np.testing.assert_array_equal(TQ.binary_tanh(x).numpy(),
                                  [-1, -1, -1, 1, 1, 1, -1])
    np.testing.assert_array_equal(
        _grad_torch(TQ.binary_tanh, np.float32([-2, -1, -0.5, 0, 0.5, 1, 2])),
        [0, 1, 1, 1, 1, 1, 0])


def test_ternarize_gradient_passes_through():
    """The identity on [-H, H], inclusive, and outside too: the JAX op clips
    with ``clip_through``, whose gradient is the identity everywhere."""
    x = np.float32([-2 * H, -H, -0.5 * H, 0.0, 0.5 * H, H, 2 * H])
    g = _grad_torch(lambda w: TQ.ternarize(w, H), x)
    np.testing.assert_array_equal(g, np.ones(7))
    np.testing.assert_array_equal(g, _grad_jax(lambda w: JQ.ternarize(w, H), x))


@pytest.mark.parametrize("seed", [0, 1])
def test_ternarize_twn_equals_jax(seed):
    """TWN's delta and alpha are reductions: the same float32 values as
    the JAX op on these inputs, and the identity gradient."""
    w = np.random.default_rng(seed).normal(0, 0.5, (64, 32)).astype(np.float32)
    want = np.asarray(JQ.ternarize_twn(jnp.asarray(w)))
    got = TQ.ternarize_twn(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_array_equal(_grad_torch(TQ.ternarize_twn, w),
                                  np.ones_like(w))


def test_twn_style_values():
    out = TQ.ternarize_twn(torch.tensor([1.0, -1.0, 0.1, -0.1, 0.9]))
    alpha = (1.0 + 1.0 + 0.9) / 3
    np.testing.assert_allclose(out.numpy(), [alpha, -alpha, 0, 0, alpha], rtol=1e-6)


def test_glorot_scale_equals_jax():
    for fi, fo in [(100, 200), (784, 4096), (1152, 1152)]:
        assert TQ.glorot_scale(fi, fo) == JQ.glorot_scale(fi, fo)


class TestStochasticBinarize:
    def test_values_and_distribution(self):
        """Values exactly in {±H}; the mean within 3 sigma of H (2p - 1)."""
        n, h = 20000, 0.5
        for w0 in (0.5 * h, -0.3 * h, 0.0):
            w = torch.full((n,), w0)
            g = torch.Generator().manual_seed(0)
            wb = TQ.binarize_stochastic(w, g, h)
            assert set(torch.unique(wb).tolist()) <= {-h, h}
            p = min(max((w0 / h + 1) / 2, 0.0), 1.0)
            sigma = h * 2 * np.sqrt(p * (1 - p) / n)
            assert abs(float(wb.mean()) - h * (2 * p - 1)) <= 3 * sigma

    def test_saturated_inputs_are_deterministic(self):
        w = torch.tensor([-2.0, -1.0, 1.0, 2.0])
        wb = TQ.binarize_stochastic(w, torch.Generator().manual_seed(3), 1.0)
        np.testing.assert_array_equal(wb.numpy(), [-1, -1, 1, 1])

    def test_gradient_equals_jax(self):
        """The saturating STE of deterministic binarize, whatever was drawn."""
        x = _points(H)
        key = jax.random.PRNGKey(1)
        want = _grad_jax(lambda w: JQ.binarize_stochastic(w[None], key, H).sum(), x)
        got = _grad_torch(lambda w: TQ.binarize_stochastic(
            w, torch.Generator().manual_seed(1), H), x)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _grad_torch(lambda w: TQ.binarize(w, H), x))

    def test_generator_replays(self):
        w = torch.from_numpy(_points(H))
        a = TQ.binarize_stochastic(w, torch.Generator().manual_seed(7), H)
        b = TQ.binarize_stochastic(w, torch.Generator().manual_seed(7), H)
        c = TQ.binarize_stochastic(w, torch.Generator().manual_seed(8), H)
        assert torch.equal(a, b) and not torch.equal(a, c)
