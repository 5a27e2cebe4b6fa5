"""Fake-quant training in the port (``qnx_torch.train``,
``qnx_torch.models.factory``) against the JAX package on the same numpy
inputs: the layers and models against flax ``apply``, one ``train_step``
against JAX's, the loop (the cases of ``tests/test_train.py`` and
``tests/test_misc_features.py``), and the engines' argmax parity on a
model trained in torch (the cases of ``tests/test_parity_{mlp,vgg}.py``).

Everything runs on the CPU at small sizes (MLP dim 64, VGG width 8)."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.models.factory import build_model as jax_build_model
from qnx.models.factory import init_model as jax_init_model
from qnx.train import loop as JL
from qnx.utils.config import Config as JConfig
from qnx_torch.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                          pack_vgg_bitplane)
from qnx_torch.data.datasets import load_dataset, synthetic
from qnx_torch.models.factory import (build_model, export_variables,
                                      init_model, init_variables,
                                      load_variables)
from qnx_torch.train import loop as TL
from qnx_torch.train.checkpoint import restore_train_state, save_checkpoint
from qnx_torch.utils.config import Config

torch.set_num_threads(2)

TINY_MLP = Config(dataset="digits", architecture="mlp", dim=64, num_hidden=2,
                  epochs=3, batch_size=64, lr_start=5e-3, lr_end=1e-3)
TINY_VGG = Config(dataset="synthetic-cifar", architecture="vgg", width=8,
                  dense_units=32, epochs=1, batch_size=16,
                  first_layer_float=True, last_layer_float=True)
CPU = "cpu"


def jcf(cf: Config) -> JConfig:
    return JConfig(**dataclasses.asdict(cf))


def np_tree(tree) -> dict:
    return jax.tree.map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def jax_outputs(cf):
    """Flax's eval-mode logits and training-mode ``batch_stats`` (none with
    dropout) on the engines' test variables ``init_variables(cf, 1)`` and
    ``images(cf, 8)``, from one compiled program."""
    module = jax_build_model(jcf(cf))
    variables, x = init_variables(cf, seed=1), images(cf, 8)

    @jax.jit
    def run(v, x):
        logits = module.apply(v, x, train=False)
        if cf.dropout_rate:  # training would need a dropout key
            return logits, {}
        _, upd = module.apply(v, x, train=True, mutable=["batch_stats"])
        return logits, upd["batch_stats"]

    logits, stats = run(variables, jnp.asarray(x))
    return variables, x, np.asarray(logits), np_tree(stats)


def torch_model(cf, variables):
    return load_variables(build_model(cf), variables)


def images(cf, n, seed=0, dyadic=False):
    """Images in [-1, 1]; ``dyadic``: on the 1/8 grid of ``digits``, so a
    layer with H = 1 sums exactly in float32 in both packages."""
    x = np.random.default_rng(seed).uniform(-1, 1, (n, *cf.input_shape))
    if dyadic:
        x = np.round(x * 8) / 8
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the layers and models against flax, eval and train mode
# ---------------------------------------------------------------------------

MLP_CASES = {
    "float": dict(network_type="float"),
    "bnn": dict(network_type="bnn"),
    "full-bnn": dict(network_type="full-bnn"),
    "full-bnn-h1-bias": dict(network_type="full-bnn", H=1.0, use_bias=True),
    "tnn": dict(network_type="tnn", wbits=2),
    "full-tnn": dict(network_type="full-tnn", wbits=2),
    "full-tnn-twn": dict(network_type="full-tnn", wbits=2, ternary_style="twn"),
    "full-tnn-abits2": dict(network_type="full-tnn", wbits=2, abits=2),
    "qnn": dict(network_type="qnn", wbits=4),
    "full-qnn": dict(network_type="full-qnn", wbits=4, abits=2),
    "binary_sigmoid": dict(network_type="full-bnn", activation="binary_sigmoid"),
    "quantized_tanh": dict(network_type="full-qnn", wbits=4, abits=3,
                           activation="quantized_tanh"),
    "quantized_relu": dict(network_type="full-bnn", activation="quantized_relu",
                           abits=2),
    "relu": dict(network_type="full-tnn", wbits=2, activation="relu"),
    "stochastic": dict(network_type="full-bnn", stochastic=True),
    "dropout": dict(network_type="full-bnn", dropout_rate=0.3),
    "last-float": dict(network_type="full-bnn", last_layer_float=True),
}
VGG_CASES = {
    "full-bnn": dict(network_type="full-bnn"),
    "full-bnn-all-binary": dict(network_type="full-bnn", first_layer_float=False,
                                last_layer_float=False),
    "full-tnn-abits2": dict(network_type="full-tnn", wbits=2, abits=2),
    "full-tnn-abits1": dict(network_type="full-tnn", wbits=2),
    "quantized_tanh": dict(network_type="full-tnn", wbits=2, abits=2,
                           activation="quantized_tanh"),
    "full-qnn": dict(network_type="full-qnn", wbits=4, abits=2),
    "qnn-relu": dict(network_type="qnn", wbits=4),
    "float": dict(network_type="float"),
}
CASES = [pytest.param(TINY_MLP.replace(**kw), id=f"mlp-{k}")
         for k, kw in MLP_CASES.items()] + \
        [pytest.param(TINY_VGG.replace(**kw), id=f"vgg-{k}")
         for k, kw in VGG_CASES.items()]


@pytest.mark.parametrize("cf", CASES)
def test_eval_logits_equal_flax(cf):
    """Eval-mode logits equal flax ``apply`` within 1e-5 with identical
    argmax, on the engines' test variables (BN statistics around each
    layer's scale, so every layer's output matters)."""
    variables, x, want, _ = jax_outputs(cf)
    with torch.no_grad():
        got = torch_model(cf, variables)(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def bn_exact(model, variables, x, train=True) -> dict:
    """The running statistics a training forward of ``model`` on ``x``
    should leave, in float64 from each BatchNorm's own float32 input."""
    from qnx_torch.train.layers import BatchNorm

    inputs, hooks = {}, []
    for name, layer in model.named_children():
        if isinstance(layer, BatchNorm):
            hooks.append(layer.register_forward_pre_hook(
                lambda mod, args, name=name: inputs.__setitem__(
                    name, args[0].detach().double().numpy())))
    with torch.no_grad():
        model(x, train=train)
    for h in hooks:
        h.remove()
    out = {}
    for name, a in inputs.items():
        a = a.reshape(-1, a.shape[-1])
        mean = a.mean(0)
        var = np.maximum((a * a).mean(0) - mean * mean, 0.0)
        old = variables["batch_stats"][name]
        out[name] = {"mean": 0.9 * old["mean"].astype(np.float64) + 0.1 * mean,
                     "var": 0.9 * old["var"].astype(np.float64) + 0.1 * var}
    return out


def assert_stats(got: dict, want: dict, exact: dict) -> None:
    """The running statistics within 1e-6 of float64 (``exact``), and
    within 1e-6 of JAX's (``want``) except where JAX's own are farther from
    float64 than that: XLA:CPU's float32 sums lose up to ~1e-5 relative
    in flax's fast variance ``mean(x^2) - mean(x)^2`` where mean^2 >> var."""
    assert set(got) == set(want) == set(exact)
    for name in want:
        for k in ("mean", "var"):
            g, w, e = got[name][k], want[name][k], exact[name][k]
            np.testing.assert_allclose(g, e, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name}/{k} against float64")
            off = ~np.isclose(g, w, rtol=1e-6, atol=1e-6)
            jax_err = np.abs(w - e)[off]
            assert (np.abs(g - e)[off] < jax_err).all() and \
                (jax_err > 1e-6 * np.abs(e[off])).all(), f"{name}/{k}"


@pytest.mark.parametrize("cf", [c for c in CASES
                                if "dropout" not in c.id and "stochastic" not in c.id])
def test_train_mode_batch_stats_equal_flax(cf):
    """flax's BatchNorm in training: the biased fast variance, the running
    statistics moved by momentum 0.9 (not torch's n/(n-1) and reversed
    momentum), within 1e-6 (:func:`assert_stats`)."""
    variables, x, _, want = jax_outputs(cf)
    exact = bn_exact(torch_model(cf, variables), variables, torch.from_numpy(x))
    model = torch_model(cf, variables)
    with torch.no_grad():
        model(torch.from_numpy(x), train=True)
    assert_stats(export_variables(model)["batch_stats"], want, exact)


@pytest.mark.parametrize("kw", [dict(strides=(2, 2)), dict(padding="VALID"),
                                dict(kernel_size=(1, 3), strides=(1, 2))],
                         ids=["same-stride2", "valid", "same-1x3-stride12"])
@pytest.mark.parametrize("float_layer", [True, False], ids=["float", "binary"])
def test_conv_layer_geometry_equals_flax(kw, float_layer):
    """The conv layers' other geometries (XLA's SAME pads the extra row at
    the end), values and input gradients, against the flax layers."""
    from qnx.train import layers as JLayers
    from qnx_torch.train import layers as TLayers

    x = np.random.default_rng(0).uniform(-1, 1, (2, 8, 7, 3)).astype(np.float32)
    jl = (JLayers.FloatConv2D(5, **kw) if float_layer
          else JLayers.BinaryConv2D(5, H=1.0, **kw))
    v = np_tree(jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want, vjp = jax.vjp(lambda a: jl.apply(v, a), jnp.asarray(x))
    tl = (TLayers.FloatConv2D(3, 5, **kw) if float_layer
          else TLayers.BinaryConv2D(3, 5, H=1.0, **kw))
    with torch.no_grad():
        tl.kernel.copy_(torch.from_numpy(v["params"]["kernel"]))
    xt = torch.from_numpy(x).requires_grad_()
    got = tl(xt)
    g = np.random.default_rng(1).normal(size=got.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)


def test_batchnorm_is_not_torch_batchnorm():
    """The running variance takes the biased batch variance with weight
    1 - momentum: torch's BatchNorm1d would differ by n/(n-1)."""
    from qnx_torch.train.layers import BatchNorm

    bn = BatchNorm(3, momentum=0.9, epsilon=1e-4)
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0)) * 3 + 1
    bn(x, train=True)
    var = x.var(0, unbiased=False)
    np.testing.assert_allclose(bn.var.numpy(), (0.9 + 0.1 * var).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), (0.1 * x.mean(0)).numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("cf", [TINY_MLP.replace(network_type="full-tnn", wbits=2),
                                TINY_VGG.replace(network_type="full-bnn")],
                         ids=["mlp", "vgg"])
def test_init_model_matches_flax(cf):
    """The tree, shapes and quant metadata (H, lr_mult) of flax init_model,
    and flax's initial distribution: latent kernels within ±H, float
    kernels within the glorot limit, biases 0, BN 1, 0, 0, 1."""
    _, want = jax_init_model(jcf(cf), jax.random.PRNGKey(0))
    want = np_tree(want)
    module, got = init_model(cf, seed=0, device=CPU)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
    for name, q in want["quant"].items():
        for k in ("H", "lr_mult"):
            assert got["quant"][name][k].dtype == np.float32
            assert got["quant"][name][k] == q[k], (name, k)
    for name, leaves in got["params"].items():
        k = leaves.get("kernel")
        if name in got["quant"]:
            h = got["quant"][name]["H"]
            assert np.abs(k).max() <= h and np.abs(k).max() > 0.9 * h
        elif k is not None:
            fan_in = np.prod(k.shape[:-1])
            fan_out = k.shape[-1] * np.prod(k.shape[:-2])
            assert np.abs(k).max() <= np.sqrt(6 / (fan_in + fan_out))
        if "bias" in leaves and "scale" not in leaves:
            assert not leaves["bias"].any()
    for name, s in got["batch_stats"].items():
        assert (s["mean"] == 0).all() and (s["var"] == 1).all()
        assert (got["params"][name]["scale"] == 1).all()
    assert init_model(cf, seed=0, device=CPU)[1]["params"]["dense_0"]["kernel"].tobytes() == \
        got["params"]["dense_0"]["kernel"].tobytes()


def test_quant_collection_has_h_and_lrmult():
    cf = TINY_MLP.replace(network_type="full-bnn", H="Glorot")
    _, variables = init_model(cf, 0, CPU)
    q = variables["quant"]["dense_0"]
    assert float(q["H"]) == pytest.approx(np.sqrt(1.5 / (64 + 64)), rel=1e-5)
    assert float(q["lr_mult"]) == pytest.approx(1.0 / float(q["H"]), rel=1e-5)
    cf = cf.replace(kernel_lr_multiplier=3.0)
    assert float(init_model(cf, 0, CPU)[1]["quant"]["dense_0"]["lr_mult"]) == 3.0


def test_float_layers_have_no_quant_metadata():
    _, variables = init_model(TINY_VGG.replace(network_type="full-bnn"), 0, CPU)
    assert "conv_0" not in variables["quant"]
    assert "conv_1" in variables["quant"]
    assert "dense_out" not in variables["quant"]


@pytest.mark.parametrize("cf", CASES[:3] + CASES[-8:-6])
def test_export_load_round_trip_exact(cf):
    v = init_variables(cf, seed=4)
    out = export_variables(torch_model(cf, v))
    assert jax.tree.structure(out) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(v)):
        assert a.dtype == np.float32 and a.tobytes() == np.asarray(b, np.float32).tobytes()


def test_load_variables_refuses_a_wrong_tree():
    cf = TINY_MLP.replace(network_type="full-bnn")
    v = init_variables(cf, seed=0)
    model = build_model(cf)
    bad = jax.tree.map(lambda a: a, v)
    del bad["params"]["bn_0"]
    with pytest.raises(ValueError, match="layers"):
        load_variables(model, bad)
    bad = jax.tree.map(lambda a: a, v)
    bad["params"]["dense_0"]["kernel"] = bad["params"]["dense_0"]["kernel"][:-1]
    with pytest.raises(ValueError, match="shape"):
        load_variables(model, bad)


def test_vgg_flatten_is_nhwc():
    """dense_0's rows are in the NHWC order of JAX's flatten: permuting the
    kernel rows as an NCHW flatten would changes the logits."""
    cf = TINY_VGG.replace(network_type="full-bnn")
    v, x, want, _ = jax_outputs(cf)
    k = v["params"]["dense_0"]["kernel"]
    c = 4 * cf.width
    perm = np.arange(k.shape[0]).reshape(4, 4, c).transpose(2, 0, 1).reshape(-1)
    v2 = jax.tree.map(lambda a: a, v)
    v2["params"]["dense_0"]["kernel"] = k[perm]
    with torch.no_grad():
        same = torch_model(cf, v)(torch.from_numpy(x)).numpy()
        other = torch_model(cf, v2)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(same, want, rtol=1e-5, atol=1e-5)
    assert np.abs(other - want).max() > 1e-3


# ---------------------------------------------------------------------------
# one train_step against JAX's
# ---------------------------------------------------------------------------

# (config, inputs on the 1/8 grid, gradient atol).  H = 1 with binary
# weights and activations and inputs on the 1/8 grid: every layer sums
# exactly in float32 in both packages, and the gradients agree within
# atol 1e-7.  Where the forward sums floats (Glorot H, levels through BN,
# crossentropy), JAX's and torch's gradients each sit up to ~1e-5 of the
# tensor's largest gradient from a float64 run of the same model (the
# float32 noise of a sum over the batch's ~1e4 terms; measured on these
# cases, both sides alike), so the atol there is 1e-5 max|g|.
STEP_CASES = {
    "mlp-full-bnn-h1": (TINY_MLP.replace(network_type="full-bnn", H=1.0), 1e-7),
    "vgg-full-bnn-h1": (TINY_VGG.replace(network_type="full-bnn", H=1.0), 1e-7),
    "mlp-full-bnn-glorot": (TINY_MLP.replace(network_type="full-bnn"), "f32"),
    "mlp-full-tnn": (TINY_MLP.replace(network_type="full-tnn", wbits=2), "f32"),
    "mlp-full-qnn-crossentropy": (TINY_MLP.replace(
        network_type="full-qnn", wbits=4, abits=2, loss="crossentropy"), "f32"),
    "vgg-full-tnn-abits2-h1": (TINY_VGG.replace(network_type="full-tnn", wbits=2,
                                                abits=2, H=1.0), "f32"),
}


def _jax_step(cf, variables, x, y):
    """JAX's loss, lr_mult-scaled gradients and the state after its
    train_step from ``variables``, in one compiled program; the state is
    the one ``create_train_state`` builds."""
    import optax

    j = jcf(cf)
    schedule = JL.exp_decay_schedule(j, 10)
    tx = optax.adam(schedule)
    state = JL.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        quant=variables["quant"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx,
        apply_fn=jax_build_model(j).apply, loss_fn=JL.make_loss(j),
        schedule=schedule)

    @jax.jit
    def run(state):
        def loss_fn(params):
            logits, _ = state.apply_fn(
                {"params": params, "quant": state.quant,
                 "batch_stats": state.batch_stats},
                x, train=True, mutable=["batch_stats"])
            return state.loss_fn(logits, y)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return (loss, JL.scale_kernel_grads(grads, state.quant),
                JL.train_step(state, x, y)[0])

    loss, grads, state = run(state)
    return float(loss), np_tree(grads), state


@pytest.mark.parametrize("cf,grad_atol", list(STEP_CASES.values()),
                         ids=list(STEP_CASES))
def test_train_step_equals_jax(cf, grad_atol):
    """From the same variables and batch: the loss within 1e-6 relative;
    the quantized layers' kernel gradients (times lr_mult) within rtol 1e-4
    and the case's atol (:data:`STEP_CASES`); the parameters after Adam
    within 1e-3 lr_start where the gradient is resolved: |g| > 100 times
    Adam's eps, and torch's and JAX's gradients within 1% (over 90% of
    every quantized kernel).  Elsewhere, as the bias of a layer that a
    training-mode BN follows (its true gradient is 0), Adam's first step
    divides float32 noise by |g| + eps, and only |step| <= lr holds.  The
    BN running statistics as :func:`assert_stats`."""
    _, variables = init_model(cf, 0, CPU)  # flax's initial distribution
    x = images(cf, 8, seed=6, dyadic=True)
    y = np.random.default_rng(7).integers(0, 10, 8).astype(np.int32)
    jloss, jgrads, jstate = _jax_step(cf, variables, jnp.asarray(x), jnp.asarray(y))

    state = TL.create_train_state(cf, 0, 10, CPU)
    load_variables(state.module, variables)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    exact = bn_exact(torch_model(cf, variables), variables, xt)
    probe = torch_model(cf, variables)
    loss = state.loss_fn(probe(xt, train=True), yt).detach()
    grads = TL.scale_kernel_grads(
        TL.param_grads(probe, state.loss_fn(probe(xt, train=True), yt)),
        TL.tensor_tree(probe)["quant"])
    state, metrics = TL.train_step(state, xt, yt)

    assert float(metrics["loss"]) == pytest.approx(jloss, rel=1e-6)
    assert float(loss) == pytest.approx(jloss, rel=1e-6)
    atol = {}
    for name, leaves in jgrads.items():
        for k, g in leaves.items():
            atol[name, k] = (grad_atol if grad_atol != "f32"
                             else 1e-5 * float(np.abs(g).max()))
    for name in variables["quant"]:
        np.testing.assert_allclose(grads[name]["kernel"].numpy(),
                                   jgrads[name]["kernel"], rtol=1e-4,
                                   atol=atol[name, "kernel"], err_msg=name)
    got = export_variables(state.module)
    lr = cf.lr_start
    resolved = []
    for name, leaves in np_tree(jstate.params).items():
        for k, want in leaves.items():
            p, p0 = got["params"][name][k], variables["params"][name][k]
            gj, gt = jgrads[name][k], grads[name][k].numpy()
            res = (np.abs(gj) > 100 * TL.ADAM_EPS) & (np.abs(gt - gj) <= 1e-2 * np.abs(gj))
            np.testing.assert_allclose(p[res], want[res], rtol=0, atol=1e-3 * lr,
                                       err_msg=f"{name}/{k}")
            assert (np.abs(p - p0)[~res] <= lr * (1 + 1e-5)).all()
            if name in variables["quant"]:
                resolved.append(res.mean())
    assert min(resolved) > 0.9
    assert_stats(got["batch_stats"], np_tree(jstate.batch_stats), exact)
    assert state.step == int(jstate.step) == 1


def test_adam_equals_optax_over_steps():
    """The optimizer half of three steps (``apply_gradients``: lr_mult,
    Adam at a decaying schedule, Clip) against JAX's ``scale_kernel_grads``,
    optax.adam and ``clip_constraint`` on the same fixed gradients: the
    parameters and the moments agree within float32 rounding, the first
    step at lr_start.  torch's moment update is a ``lerp``, optax's
    ``(1-b) g + b m``: where the three steps' terms cancel, they differ
    by up to 2 ulps of the tensor's largest moment (measured: one)."""
    import optax

    cf = TINY_MLP.replace(network_type="full-bnn", epochs=3)
    state = TL.create_train_state(cf, 0, 1, CPU)
    v = export_variables(state.module)
    rng = np.random.default_rng(0)
    gs = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * s).astype(np.float32),
                       v["params"]) for s in (1.0, 1e-3, 10.0)]
    given = jax.tree.map(np.copy, gs)
    tx = optax.adam(JL.exp_decay_schedule(jcf(cf), 1))
    jp, jo = v["params"], tx.init(v["params"])
    for g in gs:
        u, jo = tx.update(JL.scale_kernel_grads(g, v["quant"]), jo, jp)
        jp = JL.clip_constraint(optax.apply_updates(jp, u), v["quant"])
        TL.apply_gradients(state, jax.tree.map(torch.from_numpy, g))
    got, jp = export_variables(state.module)["params"], np_tree(jp)
    mu, nu = np_tree(jo[0].mu), np_tree(jo[0].nu)
    for name, leaves in state.params.items():
        for k, p in leaves.items():
            np.testing.assert_allclose(got[name][k], jp[name][k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name}/{k}")
            st = state.optimizer.state[p]
            for m, want in ((st["exp_avg"], mu[name][k]), (st["exp_avg_sq"], nu[name][k])):
                np.testing.assert_allclose(m.numpy(), want, rtol=1e-6,
                                           atol=2 * np.spacing(np.abs(want).max()),
                                           err_msg=f"{name}/{k}")
            assert int(st["step"]) == 3
    assert state.step == 3 and TL.exp_decay_schedule(cf, 1)(0) == cf.lr_start
    for a, b in zip(jax.tree.leaves(gs), jax.tree.leaves(given)):
        np.testing.assert_array_equal(a, b)  # the gradients are left as given


def test_exp_decay_schedule_equals_jax():
    cf = TINY_MLP.replace(epochs=5, lr_start=1e-3, lr_end=1e-6)
    want = JL.exp_decay_schedule(jcf(cf), 7)
    got = TL.exp_decay_schedule(cf, 7)
    for step in (0, 6, 7, 13, 20, 34, 35, 70):
        assert got(step) == pytest.approx(float(want(jnp.int32(step))), rel=1e-6)


# ---------------------------------------------------------------------------
# the loop (tests/test_train.py, tests/test_misc_features.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ntype", ["float", "bnn", "full-bnn", "tnn",
                                   "full-tnn", "qnn", "full-qnn"])
def test_mlp_builds_and_steps(ntype):
    cf = TINY_MLP.replace(network_type=ntype, wbits=4, abits=2)
    state = TL.create_train_state(cf, 0, 10, CPU)
    state, metrics = TL.train_step(state, torch.ones(8, 8, 8, 1),
                                   torch.zeros(8, dtype=torch.long))
    assert torch.isfinite(metrics["loss"]) and state.step == 1


def test_vgg_builds_and_steps():
    state = TL.create_train_state(TINY_VGG.replace(network_type="full-bnn"), 0, 10, CPU)
    _, metrics = TL.train_step(state, torch.ones(2, 32, 32, 3),
                               torch.zeros(2, dtype=torch.long))
    assert torch.isfinite(metrics["loss"])


def test_clip_constraint_applied():
    cf = TINY_MLP.replace(network_type="full-bnn", H=0.25)
    state = TL.create_train_state(cf, 0, 10, CPU)
    params = state.params
    with torch.no_grad():
        for leaves in params.values():
            for t in leaves.values():
                t.add_(10.0)
    TL.clip_constraint(params, state.quant)
    assert float(params["dense_0"]["kernel"].max()) <= 0.25
    assert float(params["bn_0"]["scale"].max()) > 1.0  # BN is not clipped
    assert float(params["dense_out"]["kernel"].max()) <= 0.25


def test_train_step_clips_quantized_kernels_only():
    """After a step with a large learning rate every quantized latent kernel
    lies in ±H; the float layers' kernels are not clipped."""
    cf = TINY_VGG.replace(network_type="full-bnn", lr_start=10.0, lr_end=10.0)
    state = TL.create_train_state(cf, 0, 10, CPU)
    x = torch.from_numpy(images(cf, 4))
    state, _ = TL.train_step(state, x, torch.arange(4))
    v = export_variables(state.module)
    for name, q in v["quant"].items():
        assert np.abs(v["params"][name]["kernel"]).max() <= q["H"]
    h0 = np.sqrt(6 / (27 + 72))
    assert np.abs(v["params"]["conv_0"]["kernel"]).max() > h0


def test_binary_weights_are_binary_in_forward():
    cf = TINY_MLP.replace(network_type="full-bnn", H=1.0)
    model, v = init_model(cf, 1, CPU)
    x = torch.from_numpy(images(cf, 4))
    with torch.no_grad():
        a = model(x)
        k = model.dense_0.kernel
        k.copy_(torch.where(k > 0, 0.9, -0.9))
        b = model(x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_fit_trains_on_tail_batch():
    """70 samples at batch 32: 2 whole steps + one 6-sample step an epoch."""
    ds = synthetic((8, 8, 1), n_train=70, n_test=20)
    cf = TINY_MLP.replace(epochs=2, batch_size=32)
    state, hist = TL.fit(cf, ds.as_tuples(), device=CPU)
    assert state.step == 2 * 3 and len(hist[-1]["train"]["losses"]) == 3
    state, _ = TL.fit(cf, ds.as_tuples(), drop_remainder=True, device=CPU)
    assert state.step == 2 * 2


def test_fit_smaller_than_batch_dataset():
    ds = synthetic((8, 8, 1), n_train=20, n_test=8)
    cf = TINY_MLP.replace(epochs=2, batch_size=64)
    state, history = TL.fit(cf, ds.as_tuples(), device=CPU)
    assert state.step == 2
    assert np.isfinite(history[-1]["test"]["loss"])


def test_fit_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TL.fit(TINY_MLP, synthetic((8, 8, 1), n_train=8, n_test=8).as_tuples())


@pytest.mark.parametrize("kw,floor", [
    (dict(network_type="full-bnn", epochs=5), 0.5),
    (dict(network_type="full-bnn", activation="binary_sigmoid", epochs=5), 0.5),
    (dict(network_type="full-qnn", wbits=4, abits=2, activation="quantized_tanh",
          epochs=5), 0.5),
    (dict(network_type="full-bnn", H=1.0, dim=48, dropout_rate=0.2, epochs=4), 0.4),
], ids=["full-bnn", "binary_sigmoid", "quantized_tanh", "dropout"])
def test_mlp_learns_digits(kw, floor):
    ds = load_dataset("digits")
    cf = TINY_MLP.replace(**kw)
    state, history = TL.fit(cf, ds.as_tuples(), device=CPU)
    acc = history[-1]["test"]["accuracy"]
    assert acc > floor, f"failed to learn digits: acc={acc}"
    n = ds.x_train.shape[0]
    assert state.step == cf.epochs * -(-n // cf.batch_size)


def test_fit_with_stochastic_runs():
    cf = TINY_MLP.replace(network_type="full-bnn", H=1.0, dim=48, stochastic=True,
                          epochs=2)
    _, history = TL.fit(cf, load_dataset("digits").as_tuples(), device=CPU)
    assert np.isfinite(history[-1]["test"]["loss"])
    assert all(np.isfinite(history[-1]["train"]["losses"]))


def test_stochastic_layer_draws_only_in_training():
    cf = TINY_MLP.replace(network_type="full-bnn", H=1.0, dim=48, stochastic=True)
    x = torch.from_numpy(images(cf, 8, seed=2))
    y = torch.zeros(8, dtype=torch.long)

    def step(seed):
        state = TL.create_train_state(cf, 0, 4, CPU)
        return float(TL.train_step(state, x, y, torch.Generator().manual_seed(seed))
                     [1]["loss"])

    assert step(3) != step(4) and step(3) == step(3)
    model = init_model(cf, 0, CPU)[0]
    with torch.no_grad():
        np.testing.assert_array_equal(model(x).numpy(), model(x).numpy())


def test_dropout_needs_a_generator_in_training():
    cf = TINY_MLP.replace(dropout_rate=0.3)
    state = TL.create_train_state(cf, 0, 4, CPU)
    x, y = torch.from_numpy(images(cf, 8)), torch.zeros(8, dtype=torch.long)
    with pytest.raises(ValueError, match="generator"):
        TL.train_step(state, x, y)
    _, m = TL.train_step(state, x, y, torch.Generator().manual_seed(5))
    assert torch.isfinite(m["loss"])


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

RESUME_CF = TINY_MLP.replace(epochs=4, batch_size=32, stochastic=True,
                             dropout_rate=0.2)


def _same_state(a, b):
    for x, y in zip(jax.tree.leaves(export_variables(a.module)),
                    jax.tree.leaves(export_variables(b.module))):
        np.testing.assert_array_equal(x, y)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and list(sa["state"]) == list(sb["state"])
    for i, leaves in sa["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(leaves[k], sb["state"][i][k])
    assert a.step == b.step == int(sa["state"][0]["step"])


def test_resume_is_bit_exact(tmp_path):
    """Interrupted after 2 epochs and resumed: the parameters, BN
    statistics, Adam moments, step and test metrics equal an uninterrupted
    run's bit for bit, with the shuffle, dropout and stochastic
    binarization drawn from the epochs' generators."""
    ds = synthetic((8, 8, 1), n_train=128, n_test=32)
    state_full, hist_full = TL.fit(RESUME_CF, ds.as_tuples(), device=CPU)
    d = str(tmp_path / "ckpt")
    TL.fit(RESUME_CF, ds.as_tuples(), ckpt_dir=d, stop_after=2, device=CPU)
    state_res, hist_res = TL.fit(RESUME_CF, ds.as_tuples(), ckpt_dir=d, resume=True,
                                 device=CPU)
    assert [h["epoch"] for h in hist_res] == [2, 3]
    _same_state(state_full, state_res)
    assert hist_full[-1] == hist_res[-1]


def test_resume_can_extend_epochs(tmp_path):
    ds = synthetic((8, 8, 1), n_train=64, n_test=16)
    cf2 = TINY_MLP.replace(epochs=2, batch_size=32)
    d = str(tmp_path / "ckpt")
    TL.fit(cf2, ds.as_tuples(), ckpt_dir=d, device=CPU)
    cf4 = cf2.replace(epochs=4)
    state, hist = TL.fit(cf4, ds.as_tuples(), ckpt_dir=d, resume=True, device=CPU)
    assert [h["epoch"] for h in hist] == [2, 3]
    assert state.step == 4 * 2
    step = 3 * 2
    want = TL.exp_decay_schedule(cf4, 2)(step)
    assert state.schedule(step) == want
    assert state.schedule(step) != pytest.approx(TL.exp_decay_schedule(cf2, 2)(step),
                                                 rel=1e-3)


def _refusal(tmp_path, match, *, stop_after=1, edit=None, resume_cf=None,
             resume_ds=None, **resume_kw):
    ds = synthetic((8, 8, 1), n_train=70, n_test=16)
    cf = TINY_MLP.replace(epochs=3, batch_size=32)
    d = str(tmp_path / "ckpt")
    TL.fit(cf, ds.as_tuples(), ckpt_dir=d, stop_after=stop_after,
           drop_remainder=resume_kw.pop("saved_drop", False), device=CPU)
    if edit:
        scp = os.path.join(d, "train_state.config.json")
        with open(scp) as f:
            sc = json.load(f)
        edit(sc)
        with open(scp, "w") as f:
            json.dump(sc, f)
    with pytest.raises(ValueError, match=match):
        TL.fit(resume_cf or cf, (resume_ds or ds).as_tuples(), ckpt_dir=d,
               resume=True, device=CPU, **resume_kw)
    return cf, ds, d


def test_resume_rejects_different_data(tmp_path):
    cf, ds, d = _refusal(tmp_path, "DIFFERENT data", resume_ds=synthetic(
        (8, 8, 1), n_train=70, n_test=16, seed=99))
    TL.fit(cf, ds.as_tuples(), ckpt_dir=d, resume=True, device=CPU)


def test_resume_rejects_config_mismatch(tmp_path):
    _refusal(tmp_path, "config differs", resume_cf=TINY_MLP.replace(
        epochs=3, batch_size=32, dim=32))


def test_resume_rejects_drop_remainder_flip(tmp_path):
    cf, ds, d = _refusal(tmp_path, "optimizer steps", saved_drop=True)
    TL.fit(cf, ds.as_tuples(), ckpt_dir=d, resume=True, drop_remainder=True,
           device=CPU)


def test_restore_rejects_stale_sidecar(tmp_path):
    _refusal(tmp_path, "internally inconsistent", stop_after=2,
             edit=lambda sc: sc.update(epochs_done=1))


def test_resume_accepts_legacy_v1_fingerprint(tmp_path):
    ds = synthetic((8, 8, 1), n_train=64, n_test=16)
    cf = TINY_MLP.replace(epochs=2, batch_size=32)
    d = str(tmp_path / "ckpt")
    TL.fit(cf, ds.as_tuples(), ckpt_dir=d, stop_after=1, device=CPU)
    scp = os.path.join(d, "train_state.config.json")
    with open(scp) as f:
        sc = json.load(f)
    sc["data_fp"] = {k: sc["data_fp"][k] for k in ("n", "x_sum", "y_sum")}
    with open(scp, "w") as f:
        json.dump(sc, f)
    _, hist = TL.fit(cf, ds.as_tuples(), ckpt_dir=d, resume=True, device=CPU)
    assert [h["epoch"] for h in hist] == [1]


def test_resume_rejects_weights_only_checkpoint(tmp_path):
    cf = TINY_MLP
    p = save_checkpoint(str(tmp_path / "w"), init_model(cf, 0, CPU)[1], cf)
    with pytest.raises(ValueError, match="weights-only"):
        restore_train_state(p, steps_per_epoch=4, device=CPU)


def test_resume_without_a_checkpoint_raises(tmp_path):
    ds = synthetic((8, 8, 1), n_train=16, n_test=8)
    with pytest.raises(FileNotFoundError):
        TL.fit(TINY_MLP, ds.as_tuples(), ckpt_dir=str(tmp_path / "none"),
               resume=True, device=CPU)


def test_stop_after_already_met_is_noop(tmp_path):
    ds = synthetic((8, 8, 1), n_train=64, n_test=16)
    cf = TINY_MLP.replace(epochs=4, batch_size=32)
    d = str(tmp_path / "ckpt")
    TL.fit(cf, ds.as_tuples(), ckpt_dir=d, stop_after=2, device=CPU)
    state, hist = TL.fit(cf, ds.as_tuples(), ckpt_dir=d, resume=True, stop_after=2,
                         device=CPU)
    assert hist == [] and state.step == 2 * 2


def test_ckpt_every_skips_and_always_saves_last(tmp_path):
    ds = synthetic((8, 8, 1), n_train=64, n_test=16)
    cf3 = TINY_MLP.replace(epochs=3, batch_size=32)
    d = str(tmp_path / "ckpt")
    TL.fit(cf3, ds.as_tuples(), ckpt_dir=d, ckpt_every=2, device=CPU)
    with open(os.path.join(d, "train_state.config.json")) as f:
        assert json.load(f)["epochs_done"] == 3
    _, hist = TL.fit(cf3.replace(epochs=4), ds.as_tuples(), ckpt_dir=d, resume=True,
                     ckpt_every=2, device=CPU)
    assert [h["epoch"] for h in hist] == [3]


@pytest.mark.parametrize("n", [400, 100, 7])
def test_data_fingerprint_equals_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    assert TL.data_fingerprint(x, y) == JL.data_fingerprint(x, y)


def test_fingerprint_v2_catches_reshuffle():
    x = np.zeros((400, 4), np.float32)
    x[10, 0], x[20, 0] = 1.0, 2.0
    y = np.zeros(400, np.int64)
    fp1 = TL.data_fingerprint(x, y)
    x[10, 0], x[20, 0] = 2.0, 1.0
    fp2 = TL.data_fingerprint(x, y)
    assert fp1["x_sum"] == fp2["x_sum"] and fp1["sha"] != fp2["sha"]
    assert fp1["v"] == 2


# ---------------------------------------------------------------------------
# the engines on a model trained in torch (tests/test_parity_{mlp,vgg}.py)
# ---------------------------------------------------------------------------

def _fake_argmax(cf, variables, x):
    with torch.no_grad():
        return torch_model(cf, variables)(torch.from_numpy(x)).argmax(-1).numpy()


def _engine_argmax(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).argmax(-1).numpy()


@pytest.fixture(scope="module")
def digits():
    return load_dataset("digits")


@pytest.mark.parametrize("kw,engines,floor", [
    (dict(network_type="full-bnn", H=1.0), ("mlp", "int8"), 1.0),
    (dict(network_type="full-tnn", wbits=2, H=1.0), ("mlp", "int8"), 1.0),
    (dict(network_type="full-bnn"), ("mlp", "int8"), 0.995),
], ids=["bnn-h1", "tnn-h1", "bnn-glorot"])
def test_mlp_trained_in_torch_keeps_engine_parity(digits, kw, engines, floor):
    cf = TINY_MLP.replace(dim=96, num_hidden=3, **kw)
    state, history = TL.fit(cf, digits.as_tuples(), device=CPU)
    assert history[-1]["test"]["accuracy"] > 0.5
    v = export_variables(state.module)
    x = digits.x_test
    gold = _fake_argmax(cf, v, x)
    for name in engines:
        model = (pack_mlp if name == "mlp" else pack_int8)(v, cf, device=CPU)
        match = float(np.mean(_engine_argmax(model, x) == gold))
        assert match >= floor, f"{name}: argmax parity {match:.4f}"
    acc = float(np.mean(_engine_argmax(pack_mlp(v, cf, device=CPU), x)
                        == digits.y_test))
    if floor == 1.0:
        # evaluate() averages the batches' float32 accuracies
        assert acc == pytest.approx(history[-1]["test"]["accuracy"], abs=1e-6)


VGG_PARITY = {
    "bnn": (dict(network_type="full-bnn"), (pack_vgg, pack_int8)),
    "tnn-abits1": (dict(network_type="full-tnn", wbits=2), (pack_vgg, pack_int8)),
    "all-binary": (dict(network_type="full-bnn", first_layer_float=False,
                        last_layer_float=False), (pack_vgg,)),
    "tnn-abits2": (dict(network_type="full-tnn", wbits=2, abits=2),
                   (pack_vgg_bitplane, pack_int8)),
}


@pytest.mark.parametrize("kw,packers", list(VGG_PARITY.values()), ids=list(VGG_PARITY))
def test_vgg_trained_in_torch_keeps_engine_parity(kw, packers):
    """H = 1: the fake-quant convs sum exactly, so the engines' argmax equals
    the fake-quant model's on every image, and export_variables feeds the
    converters with no adapter."""
    cf = TINY_VGG.replace(dense_units=64, H=1.0, **kw)
    ds = synthetic((32, 32, 3), n_train=96, n_test=64)
    state, _ = TL.fit(cf, ds.as_tuples(), device=CPU)
    v = export_variables(state.module)
    gold = _fake_argmax(cf, v, ds.x_test)
    for pack in packers:
        got = _engine_argmax(pack(v, cf, device=CPU), ds.x_test)
        assert float(np.mean(got == gold)) == 1.0, pack.__name__
