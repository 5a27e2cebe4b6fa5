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
from qnx_torch.native import hostlib
from qnx_torch.nn.inference import mlp_forward
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
    with pytest.raises(NotImplementedError, match="item 14"):
        ServeEngine(model, mesh=object())
