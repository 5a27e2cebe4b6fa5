"""The port's ServeEngine against the JAX package's: its parameters in JAX's
order, ``forward=``, ``device_normalize=False`` and mixed uint8/float32
batches (normalised on the host by qnx_torch.native, bit-equal to the
on-device normalisation), and uint8 ingest against the JAX engine."""
import inspect
import queue

import numpy as np
import pytest
import torch

from engine_test_utils import MLP_CF, VGG_CF
from qnx.convert.pack_model import pack_mlp as jax_pack_mlp
from qnx.native import available as jax_native_available
from qnx.native import u8_to_f32 as jax_u8_to_f32
from qnx.nn.inference import mlp_forward as jax_mlp_forward
from qnx.serve.engine import ServeEngine as JaxServeEngine
from qnx_torch.convert.pack_model import pack_int8, pack_mlp, pack_vgg
from qnx_torch.models.factory import init_variables
from qnx_torch.native import hostlib, u8_to_f32
from qnx_torch.nn.inference import mlp_forward
from qnx_torch.serve import routes
from qnx_torch.serve.engine import ServeEngine, normalize_u8

torch.set_num_threads(2)

# logits of the same bits: only the float first layer's f32 summation order
# differs between XLA and torch (tests/test_torch_mlp.py)
RTOL, ATOL_REL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def variables():
    return init_variables(MLP_CF, seed=3)


@pytest.fixture(scope="module")
def model(variables):
    return pack_mlp(variables, MLP_CF, device="cpu")


def _u8(n, seed, shape=(28, 28, 1)):
    return np.random.RandomState(seed).randint(0, 256, (n, *shape), np.uint8)


def _serve(engine, chunks):
    """Queue ``chunks`` before the start (so the batching is deterministic),
    serve them, return the logits in order."""
    futs = [f for c in chunks for f in engine.submit_many(c)]
    with engine:
        return np.stack([f.result(timeout=120) for f in futs])


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_parameters_are_the_jax_engines_in_order():
    ours = inspect.signature(ServeEngine.__init__).parameters
    want = inspect.signature(JaxServeEngine.__init__).parameters
    assert list(ours) == list(want)
    assert [p.default for p in ours.values()] == [p.default for p in
                                                  want.values()]


def test_positional_arguments_in_jax_order(model):
    """The fifth positional argument is ``forward``, the sixth
    ``device_normalize``, the seventh ``max_queue``."""
    calls = []

    def forward(m, x):
        calls.append(x.dtype)
        return m(x)

    engine = ServeEngine(model, 4, None, 50.0, forward, False, 2)
    assert engine.device_normalize is False
    assert engine._queue.maxsize == 2
    engine.submit_many(_u8(2, 0))
    engine.submit_many(_u8(2, 1))
    with pytest.raises(queue.Full):
        engine.submit_many(_u8(2, 2), timeout=0.05)
    engine.stop()
    engine = ServeEngine(model, 4, None, 50.0, forward)
    _serve(engine, [_u8(3, 0)])
    assert calls == [torch.float32]


def test_forward_is_called_on_the_normalised_batch(model):
    u8 = _u8(6, 4)
    seen = []

    def forward(m, x):
        seen.append((tuple(x.shape), x.dtype, torch.is_inference_mode_enabled()))
        return m(x) * 2.0

    got = _serve(ServeEngine(model, batch_size=4, max_wait_ms=50.0,
                             forward=forward), [u8])
    assert seen == [((4, 28, 28, 1), torch.float32, True)] * 2
    want = mlp_forward(model, normalize_u8(torch.from_numpy(u8))).numpy()
    np.testing.assert_array_equal(got, 2.0 * want)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_host_normalisation_is_bit_equal_to_the_device_path(model, route,
                                                             monkeypatch):
    """device_normalize=False sends float32 normalised by
    qnx_torch.native.u8_to_f32; the logits equal the on-device path's bit
    for bit, through the C++ build and through the numpy fallback."""
    if route == "numpy":
        monkeypatch.setattr(hostlib, "_lib", lambda: None)
    else:
        assert hostlib.available()
    u8 = _u8(11, 5)
    chunks = [u8[:3], u8[3:9], u8[9:]]
    seen = []

    def forward(m, x):
        seen.append(x.clone())
        return m(x)

    host = _serve(ServeEngine(model, batch_size=4, max_wait_ms=50.0,
                              forward=forward, device_normalize=False), chunks)
    device = _serve(ServeEngine(model, batch_size=4, max_wait_ms=50.0), chunks)
    np.testing.assert_array_equal(_bits(host), _bits(device))
    want = normalize_u8(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(
        _bits(torch.cat(seen)[:11].numpy()), _bits(want))


@pytest.mark.parametrize("cf,pack", [(MLP_CF, pack_mlp), (VGG_CF, pack_vgg),
                                     (VGG_CF, pack_int8)],
                         ids=["mlp-packed", "vgg-packed", "vgg-int8"])
def test_mixed_batch_is_bit_equal_to_pre_normalised_images(cf, pack):
    """A batch mixing uint8 and float32 chunks gives the logits of the same
    images pre-normalised, bit for bit."""
    model = pack(init_variables(cf, seed=6), cf, device="cpu")
    u8 = _u8(8, 7, cf.input_shape)
    f32 = normalize_u8(torch.from_numpy(u8)).numpy()
    mixed = _serve(ServeEngine(model, batch_size=8, max_wait_ms=50.0),
                   [u8[:3], f32[3:5], u8[5:]])
    floats = _serve(ServeEngine(model, batch_size=8, max_wait_ms=50.0), [f32])
    np.testing.assert_array_equal(_bits(mixed), _bits(floats))
    raw = _serve(ServeEngine(model, batch_size=8, max_wait_ms=50.0), [u8])
    np.testing.assert_array_equal(_bits(mixed), _bits(raw))


@pytest.mark.parametrize("device_normalize", [True, False])
def test_uint8_ingest_matches_the_jax_engine(variables, model, device_normalize):
    """TestUint8Ingest (tests/test_serve.py) against the JAX engine: the same
    uint8 requests through both engines, on the device path and the host
    path; the normalised images are bit-equal to the JAX native build's."""
    raw = _u8(6, 3)
    jax_model = jax_pack_mlp(variables, MLP_CF)
    with JaxServeEngine(jax_model, batch_size=4,
                        device_normalize=device_normalize) as eng:
        want = eng.predict(raw)
    gold = np.asarray(jax_mlp_forward(jax_model, jax_u8_to_f32(raw)))
    np.testing.assert_allclose(want, gold, atol=1e-5, rtol=1e-5)
    with ServeEngine(model, batch_size=4,
                     device_normalize=device_normalize) as eng:
        got = eng.predict(raw)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if jax_native_available():  # the JAX fallback rounds twice (ROADMAP §3)
        np.testing.assert_array_equal(_bits(hostlib.u8_to_f32(raw)),
                                      _bits(jax_u8_to_f32(raw)))


def test_mesh_is_still_refused(model):
    """A mesh is served now (tests/test_torch_parallel.py), but only over a
    joined world: without one the engine refuses it."""
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        ServeEngine(model, mesh=object())


def _unpinned(made):
    """A stand-in for ``routes._pinned``: page-locked memory needs a card."""
    def pinned(shape, dtype):
        made.append(np.empty(shape, dtype))
        return made[-1]
    return pinned


def test_a_card_engine_reuses_its_host_batch_buffer(model, monkeypatch):
    """The card route copies every batch, several chunks, a padded one or
    one full chunk, into the next of two host buffers it keeps, used in
    turn; each batch reads as the chunks and zero padding; another shape or
    dtype gets a new buffer.  On the CPU each batch is an array of its
    own."""
    made = []
    monkeypatch.setattr(routes, "_pinned", _unpinned(made))
    engine = ServeEngine(model, batch_size=8)
    assert isinstance(engine.route, routes.HostRoute)
    cpu = [engine._host_batch([(_u8(3, 1), [], 0, 0, True)], 3)[0] for _ in range(2)]
    assert cpu[0] is not cpu[1]
    assert not made
    # staging touches no card: only the launch does
    card = routes.CardRoute(model, torch.device("cuda"), 8, None)

    def batch(*chunks):
        return card.stage(list(chunks), sum(len(c) for c in chunks))

    a, b, c = _u8(3, 4), _u8(4, 5), _u8(8, 6)
    first, pad = batch(a, b)
    np.testing.assert_array_equal(first, np.concatenate([a, b, np.zeros((1, 28, 28, 1), np.uint8)]))
    assert pad == 1
    assert len(made) == 2  # the first batch makes both
    second, pad = batch(b)
    assert second is not first and pad == 4
    np.testing.assert_array_equal(second[:4], b)
    assert not second[4:].any()
    whole, pad = batch(c)  # one full chunk: staged too, in the first buffer
    assert whole is first and whole is not c and pad == 0
    np.testing.assert_array_equal(whole, c)
    again, pad = batch(a)  # and the second, its padding zeroed again
    assert again is second and pad == 5
    np.testing.assert_array_equal(again[:3], a)
    assert not again[3:].any()
    assert len(made) == 2
    third, _ = batch(u8_to_f32(a))  # float32 from the host: another buffer
    assert third is not first and third.dtype == np.float32
    assert len(made) == 3


@pytest.mark.parametrize("sizes", [(8,), (3,), (3, 4), (2, 2, 4), (1, 1)])
@pytest.mark.parametrize("float32", [False, True])
def test_host_and_card_routes_stage_and_answer_alike(model, monkeypatch, sizes,
                                                      float32):
    """The same chunks give the same zero-padded host batch on the host
    route and on the card route (its buffers unpinned, on the CPU), and the
    routes' one forward (``routes.infer``, which the card route runs after
    its copy) gives the same logits, the model's on the chunks."""
    monkeypatch.setattr(routes, "_pinned", _unpinned([]))
    chunks = [_u8(n, 10 + i) for i, n in enumerate(sizes)]
    if float32:
        chunks = [u8_to_f32(c) for c in chunks]
    total = sum(sizes)
    host = routes.HostRoute(model, torch.device("cpu"), 8, None)
    card = routes.CardRoute(model, torch.device("cuda"), 8, None)
    (h, h_pad), (c, c_pad) = host.stage(chunks, total), card.stage(chunks, total)
    assert h_pad == c_pad == 8 - total
    np.testing.assert_array_equal(h, c)
    np.testing.assert_array_equal(h[total:], 0)
    got = [routes.infer(r.forward, model, torch.from_numpy(b)).numpy()
           for r, b in ((host, h), (card, c))]
    np.testing.assert_array_equal(got[0], got[1])
    want = routes.infer(lambda m, x: m(x), model,
                        torch.from_numpy(np.concatenate(chunks))).numpy()
    np.testing.assert_array_equal(got[0][:total], want)
