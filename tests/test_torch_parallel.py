"""qnx_torch.parallel against qnx.parallel: the mesh's closed form, the
sharding rules leaf for leaf, the ring GEMMs, the TP packed forwards and
``ServeEngine(mesh=...)``.

Multi-rank cases run as worlds of CPU processes over gloo
(``qnx_torch.parallel.launch.run_world``: one thread a rank, a 90 s
collective timeout, 120 s a world), so a deadlocked ring fails the test
instead of hanging the suite.  The JAX side runs in this process on the 8
CPU devices of ``tests/conftest.py``."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.convert import pack_model as JP
from qnx.parallel import mesh as JM
from qnx.parallel import sharding as JS
from qnx.parallel import tp_forward as JT
from qnx_torch.convert import pack_model as TP
from qnx_torch.models.factory import init_variables
from qnx_torch.nn.inference import mlp_forward, vgg_forward
from qnx_torch.parallel import mesh as M
from qnx_torch.parallel import sharding as S
from qnx_torch.parallel import tp_forward as T
from qnx_torch.parallel.launch import run_world
from qnx_torch.serve.engine import ServeEngine
from qnx_torch.utils.config import CIFAR10_BNN, Config, MNIST_BNN, MNIST_TNN

torch.set_num_threads(2)

RTOL, ATOL_REL = 1e-5, 1e-4  # tests/test_torch_golden.py's logit tolerance


def fake_mesh(dp: int, mp: int):
    """What the port's pure rules read of a mesh: its shape by axis."""
    return types.SimpleNamespace(shape=(dp, mp), mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def test_default_model_parallel_equals_jax():
    for n in range(1, 65):
        assert M.default_model_parallel(n) == JM.default_model_parallel(n), n


def test_make_mesh_in_a_world_of_one(tmp_path):
    import torch.distributed as dist

    M.initialize_distributed(f"file://{tmp_path / 'init'}", 1, 0, "gloo", 30)
    try:
        mesh = M.make_mesh(1, device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert M.axis_size(mesh, "model") == M.axis_rank(mesh, "data") + 1
        assert M.transport(None, "cpu") == "gloo"
        assert M.transport(None, "cuda") == "gloo-host"
        with pytest.raises(ValueError, match="not divisible"):
            M.make_mesh(1, model_parallel=2, device_type="cpu")
        with pytest.raises(ValueError, match="spans the world"):
            M.make_mesh(4, device_type="cpu")
        with pytest.raises(ValueError, match="backend"):
            M.initialize_distributed("file:///nowhere", 1, 0, "mpi")
    finally:
        dist.destroy_process_group()


def test_partition_spec_equals_jax():
    from jax.sharding import PartitionSpec

    assert M.P(None, "model") == PartitionSpec(None, "model")
    assert M.P() == PartitionSpec()
    assert M.data_sharding(None) == PartitionSpec("data")
    assert M.replicated(None) == PartitionSpec()


# ---------------------------------------------------------------------------
# sharding rules, leaf for leaf
# ---------------------------------------------------------------------------

def _jax_specs_by_name(tree) -> dict:
    """JAX packed model pytree -> {port buffer name: spec}."""
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(p, "name", getattr(p, "idx", getattr(p, "key", p))))
                        for p in path)
        out[name] = tuple(sh.spec)
    return out


@pytest.mark.parametrize("mp", [2, 4])
def test_train_state_shardings_equal_jax(mp):
    cf = MNIST_BNN.replace(dim=64, num_hidden=2)
    variables = init_variables(cf, 0)
    jmesh = JM.make_mesh(8, model_parallel=mp)
    want = JS.train_state_shardings(jmesh, variables)
    got = S.train_state_shardings(fake_mesh(8 // mp, mp), variables)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {jax.tree_util.keystr(p): s for p, s in
              jax.tree_util.tree_flatten_with_path(
                  got, is_leaf=lambda x: isinstance(x, M.P))[0]}
    assert len(flat_w) == len(flat_g)
    for path, sh in flat_w:
        assert flat_g[jax.tree_util.keystr(path)] == sh.spec, path
    # the head's 10 classes replicate where 4 does not divide them
    assert got["params"]["dense_out"]["kernel"] == (
        M.P(None, "model") if mp == 2 else M.P())


PACKED = {
    "mlp": (MNIST_BNN.replace(dim=128), "pack_mlp"),
    "ternary_mlp": (MNIST_TNN.replace(dim=128), "pack_mlp"),
    "vgg": (CIFAR10_BNN.replace(width=16, dense_units=128), "pack_vgg"),
    "ternary_vgg": (CIFAR10_BNN.replace(width=16, dense_units=128,
                                        network_type="full-tnn", wbits=2),
                    "pack_vgg"),
    "int8_vgg": (CIFAR10_BNN.replace(width=16, dense_units=128), "pack_int8"),
    "bitplane_vgg": (CIFAR10_BNN.replace(width=16, dense_units=128,
                                         network_type="full-tnn", wbits=2,
                                         abits=2), "pack_vgg_bitplane"),
}


@pytest.mark.parametrize("kind", list(PACKED))
def test_packed_model_shardings_equal_jax(kind):
    cf, fn = PACKED[kind]
    variables = init_variables(cf, 0)
    jmodel = getattr(JP, fn)(variables, cf)
    tmodel = getattr(TP, fn)(variables, cf, device="cpu")
    want = _jax_specs_by_name(JS.packed_model_shardings(JM.make_mesh(8, model_parallel=2),
                                                        jmodel))
    got = S.packed_model_shardings(fake_mesh(4, 2), tmodel)
    extra = {n for n in got if n.rsplit(".", 1)[-1] in ("wt", "wk")}
    assert set(got) - extra == set(want)
    for name, spec in want.items():
        assert got[name] == spec, name
    for name in extra:  # the port's K-major copies follow their N axis
        axis = 1 if name.endswith("wt") else 0
        n = dict(tmodel.named_buffers())[name].shape[axis]
        assert got[name] == (S._on(axis, dict(tmodel.named_buffers())[name].dim())
                             if n % 2 == 0 else M.P()), name


def test_shard_module_slices_only_the_named_layers():
    cf = MNIST_BNN.replace(dim=128)
    model = TP.pack_mlp(init_variables(cf, 0), cf, device="cpu")
    mesh = types.SimpleNamespace(shape=(1, 4), mesh_dim_names=("data", "model"),
                                 get_local_rank=lambda axis: 2)
    local = S.shard_module(model, mesh, ("hidden.",))
    assert torch.equal(local.hidden[0].wp, model.hidden[0].wp[:, 64:96])
    assert torch.equal(local.hidden[0].tau, model.hidden[0].tau[64:96])
    assert torch.equal(local.first.w, model.first.w)
    assert torch.equal(local.head.wp, model.head.wp)


# ---------------------------------------------------------------------------
# the ring GEMMs, across processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_allgather_gemms_match_dense(m):
    from qnx_torch.ops.packing import pack_bits

    rng = np.random.default_rng(m)
    xf = rng.standard_normal((32, 64)).astype(np.float32)
    wf = rng.standard_normal((64, 48 * m // 2)).astype(np.float32)
    xi = rng.choice([-1, 1], (16, 128)).astype(np.int8)
    wi = rng.choice([-1, 1], (128, 32)).astype(np.int8)
    k = 32 * 8  # Kw = 8 splits over m = 2, 4
    xb = rng.choice([-1.0, 1.0], (8, k)).astype(np.float32)
    wb = rng.choice([-1.0, 1.0], (k, 16)).astype(np.float32)
    xp = pack_bits(torch.from_numpy(xb), -1).numpy()
    wp = pack_bits(torch.from_numpy(wb), 0).numpy()
    cases = [dict(kind="float", x=xf, w=wf), dict(kind="int8", x=xi, w=wi),
             dict(kind="popcount", x=xp, w=wp, k=k)]
    res = run_world("overlap", {"cases": cases}, m, m, device="cpu")
    assert [r["mesh"] for r in res] == [[1, m]] * m
    outs = [torch.cat([r["outs"][i] for r in res], 1).numpy() for i in range(3)]
    np.testing.assert_allclose(outs[0], xf.astype(np.float64) @ wf, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(outs[1], xi.astype(np.int32) @ wi.astype(np.int32))
    np.testing.assert_array_equal(outs[2], (xb @ wb).astype(np.int32))


# ---------------------------------------------------------------------------
# the TP packed forwards: trained in JAX, carried by the converters
# ---------------------------------------------------------------------------

def _train(cf, shape, n_train, steps):
    from qnx.data.datasets import synthetic
    from qnx.train.loop import create_train_state, train_step

    ds = synthetic(shape, n_train=n_train, n_test=16)
    state = create_train_state(cf, jax.random.PRNGKey(0), steps)
    x, y = jnp.asarray(ds.x_train), jnp.asarray(ds.y_train)
    for i in range(steps):
        state, _ = train_step(state, x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16])
    variables = jax.device_get({"params": state.params, "quant": state.quant,
                                "batch_stats": state.batch_stats})
    return jax.tree.map(np.asarray, variables), np.asarray(ds.x_test)


@pytest.fixture(scope="module")
def trained_mlp():
    cf = Config(dataset="synthetic-mnist", architecture="mlp", dim=128,
                num_hidden=3, H=1.0, network_type="full-bnn")
    variables, x = _train(cf, (28, 28, 1), 48, 3)
    return cf, variables, x


@pytest.fixture(scope="module")
def trained_vgg():
    cf = Config(dataset="synthetic-cifar", architecture="vgg", width=16,
                dense_units=128, H=1.0, network_type="full-bnn",
                first_layer_float=True, last_layer_float=True)
    variables, x = _train(cf, (32, 32, 3), 32, 2)
    return cf, variables, x


def _check_logits(got, one_rank, jax_logits):
    np.testing.assert_array_equal(got, one_rank)
    np.testing.assert_allclose(got, jax_logits, rtol=RTOL,
                               atol=ATOL_REL * np.abs(jax_logits).max())
    np.testing.assert_array_equal(got.argmax(-1), jax_logits.argmax(-1))


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_mlp_forward_bit_exact(trained_mlp, mp):
    cf, variables, x = trained_mlp
    model = TP.pack_mlp(variables, cf, device="cpu")
    assert T.tp_supported(model, fake_mesh(1, mp))
    one = mlp_forward(model, torch.from_numpy(x)).numpy()
    jmesh = JM.make_mesh(8, model_parallel=mp)
    jpacked = JP.pack_mlp(variables, cf)
    want = np.asarray(jax.jit(lambda m, xx: JT.tp_mlp_forward(m, xx, jmesh))(
        jpacked, jnp.asarray(x)))
    res = run_world("tp_forward", {"model": model, "x": x}, mp, mp, device="cpu")
    for r in res:  # every rank returns the whole batch's logits
        _check_logits(r["logits"].numpy(), one, want)


def test_tp_vgg_forward_bit_exact_dp2_mp2(trained_vgg):
    cf, variables, x = trained_vgg
    model = TP.pack_vgg(variables, cf, device="cpu")
    assert T.tp_supported(model, fake_mesh(2, 2))
    one = vgg_forward(model, torch.from_numpy(x)).numpy()
    jmesh = JM.make_mesh(4, model_parallel=2)
    want = np.asarray(jax.jit(lambda m, xx: JT.tp_vgg_forward(m, xx, jmesh))(
        JP.pack_vgg(variables, cf), jnp.asarray(x)))
    res = run_world("tp_forward", {"model": model, "x": x}, 4, 2, device="cpu")
    assert [r["mesh"] for r in res] == [[2, 2]] * 4
    for r in res:
        _check_logits(r["logits"].numpy(), one, want)


def test_tp_supported_guards():
    cf = MNIST_BNN.replace(dim=96)  # 96 % 64 != 0
    model = TP.pack_mlp(init_variables(cf, 0), cf, device="cpu")
    assert not T.tp_supported(model, fake_mesh(4, 2))
    ok = TP.pack_mlp(init_variables(MNIST_BNN.replace(dim=128), 0),
                     MNIST_BNN.replace(dim=128), device="cpu")
    assert T.tp_supported(ok, fake_mesh(4, 2))
    assert not T.tp_supported(ok, fake_mesh(8, 1))
    assert not T.tp_supported(ok, None)
    tnn = TP.pack_mlp(init_variables(MNIST_TNN.replace(dim=128), 0),
                      MNIST_TNN.replace(dim=128), device="cpu")
    assert not T.tp_supported(tnn, fake_mesh(4, 2))
    assert T.make_tp_forward(tnn, fake_mesh(4, 2)) is None


def test_batch_axis_needs_an_even_split():
    assert T._batch_axis(fake_mesh(2, 2), 8) == "data"
    assert T._batch_axis(fake_mesh(2, 2), 7) is None
    assert T._batch_axis(fake_mesh(1, 4), 8) is None


# ---------------------------------------------------------------------------
# ServeEngine(mesh=...)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,mp", [(2, 2), (4, 2)])
def test_serve_engine_mesh_paths(world, mp):
    """mnist-bnn rides the ring, mnist-tnn the replicated path; rank 0's
    answers equal one-rank serving; every rank's process ends (run_world
    raises otherwise) after rank 0's stop()."""
    cfs = {"mnist_bnn": MNIST_BNN.replace(dim=128),
           "mnist_tnn": MNIST_TNN.replace(dim=128)}
    models = {k: TP.pack_mlp(init_variables(cf, 0), cf, device="cpu")
              for k, cf in cfs.items()}
    rng = np.random.default_rng(world)
    reqs = {k: rng.integers(0, 256, (50, 28, 28, 1), dtype=np.uint8) for k in cfs}
    res = run_world("serve", {"models": models, "requests": reqs, "batch_size": 16,
                              "chunks": (8, 30, 12), "rate_batches": 4},
                    world, mp, device="cpu")
    for label, path in (("mnist_bnn", "ring"), ("mnist_tnn", "replicated")):
        with ServeEngine(models[label], batch_size=16) as eng:
            want = eng.predict(reqs[label])
            assert eng.stats()["forward_path"] == "single"
        r0 = res[0][label]
        np.testing.assert_array_equal(r0["logits"], want)
        assert r0["stats"]["forward_path"] == path
        assert r0["stats"]["world"] == world
        assert (r0["stats"]["backend"], r0["stats"]["transport"]) == ("gloo", "gloo")
        assert r0["stats"]["images"] == 50 and r0["stats"]["batches"] == 4
        # the rate serve: 4 full batches of the requests cycled, none padded
        np.testing.assert_array_equal(r0["rate"]["logits"], want[np.arange(64) % 50])
        rate = r0["rate"]["stats"]
        assert (rate["images"], rate["batches"], rate["pad_fraction"]) == (64, 4, 0.0)
        assert all(r[label]["forward_path"] == path for r in res)
        assert all("logits" not in r[label] for r in res[1:])


def test_serve_engine_replicated_path_of_every_engine():
    """The int8 and the bit-plane VGG (whose planes carry the batch in dim
    1) on the replicated path of a 2x2 mesh: each data group runs the
    layers between the first and the head on its slice; the answers equal
    one-rank serving."""
    cf = CIFAR10_BNN.replace(width=16, dense_units=64)
    tnn = cf.replace(network_type="full-tnn", wbits=2, abits=2)
    models = {"int8": TP.pack_int8(init_variables(cf, 0), cf, device="cpu"),
              "bitplane": TP.pack_vgg_bitplane(init_variables(tnn, 0), tnn,
                                               device="cpu")}
    rng = np.random.default_rng(5)
    reqs = {k: rng.integers(0, 256, (20, 32, 32, 3), dtype=np.uint8) for k in models}
    res = run_world("serve", {"models": models, "requests": reqs, "batch_size": 8},
                    4, 2, device="cpu")
    for label, model in models.items():
        with ServeEngine(model, batch_size=8) as eng:
            want = eng.predict(reqs[label])
        assert res[0][label]["stats"]["forward_path"] == "replicated"
        np.testing.assert_array_equal(res[0][label]["logits"], want)


def test_serve_engine_mesh_of_one_takes_the_single_path(tmp_path):
    import torch.distributed as dist

    cf = MNIST_BNN.replace(dim=128)
    model = TP.pack_mlp(init_variables(cf, 0), cf, device="cpu")
    reqs = np.random.default_rng(0).integers(0, 256, (20, 28, 28, 1), dtype=np.uint8)
    with ServeEngine(model, batch_size=8) as eng:
        want = eng.predict(reqs)
    M.initialize_distributed(f"file://{tmp_path / 'init'}", 1, 0, "gloo", 30)
    try:
        mesh = M.make_mesh(1, device_type="cpu")
        with ServeEngine(model, batch_size=8, mesh=mesh) as eng:
            assert eng.leader
            np.testing.assert_array_equal(eng.predict(reqs), want)
            stats = eng.stats()
        assert stats["forward_path"] == "single" and stats["world"] == 1
        assert stats["transport"] == "gloo"
    finally:
        dist.destroy_process_group()
