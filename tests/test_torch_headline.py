"""The port's headline bench (``qnx_torch.bench.headline``, the port of
``bench.py``) on the CPU: its targets against the JAX package's on the same
variables, the record with the timer stubbed (as
tests/test_torch_bench_suite.py stubs it), one small real run, and the
CLI's routes.  Real numbers come from the card (chip_smoke.py)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qnx_torch.__main__ as cli
import qnx_torch.bench.headline as headline
import qnx_torch.bench.suite as suite
from qnx.bench.float_baseline import float_forward as jax_float_forward
from qnx.convert.pack_model import pack_int8 as jax_pack_int8
from qnx.convert.pack_model import pack_vgg as jax_pack_vgg
from qnx.models.factory import init_model as jax_init_model
from qnx.nn.inference import vgg_forward as jax_vgg_forward
from qnx.nn.int8_engine import i8_forward as jax_i8_forward
from qnx.utils.config import CIFAR10_BNN as JAX_CIFAR10_BNN
from qnx_torch.utils.config import CIFAR10_BNN

torch.set_num_threads(2)

#: bench.py:97-109's record; ``unreliable`` (bench.py:110-111) joins only
#: when a target's estimate is flagged
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_batch",
               "ms_median", "spread", "baseline_f32_ips", "baseline_spread",
               "repeats"}
# the repo's logit gate (PERF.md §2): equal codes feed the same float head;
# only the f32 summation order of the float layers differs
RTOL, ATOL_REL = 1e-5, 1e-4
SMALL = dict(width=16, dense_units=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's variables (and the float twin's) from ``init_model(cf,
    PRNGKey(0))`` as numpy, images from a numpy seed, and JAX's logits of
    each target on them."""
    jcf = JAX_CIFAR10_BNN.replace(**SMALL)
    jcf_f = jcf.replace(network_type="float")
    _, v = jax_init_model(jcf, jax.random.PRNGKey(0))
    _, vf = jax_init_model(jcf_f, jax.random.PRNGKey(0))
    v, vf = _np_tree(v), _np_tree(vf)
    x = np.random.default_rng(3).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    with jax.default_matmul_precision("highest"):
        strict = np.asarray(jax.jit(lambda vv, xx: jax_float_forward(vv, jcf_f, xx))(vf, xj))
    want = {
        "int8": np.asarray(jax_i8_forward(jax_pack_int8(v, jcf), xj)),
        "f32-strict": strict,
        # the CPU has no TF32: the twin computes in float32, as strict
        "tf32": strict,
        "popcount": np.asarray(jax_vgg_forward(jax_pack_vgg(v, jcf), xj)),
    }
    return v, vf, x, want


@pytest.mark.parametrize("name", ["int8", "f32-strict", "tf32", "popcount"])
def test_targets_match_jax(jax_run, name):
    v, vf, x, want = jax_run
    targets = headline.headline_targets(v, CIFAR10_BNN.replace(**SMALL),
                                        torch.from_numpy(x), full=True, vars_f=vf)
    assert list(targets) == ["f32-strict", "int8", "tf32", "popcount"]
    fn, args = targets[name]
    with torch.inference_mode():
        got = fn(*args).numpy()
    np.testing.assert_allclose(got, want[name], rtol=RTOL,
                               atol=ATOL_REL * np.abs(want[name]).max())
    np.testing.assert_array_equal(got.argmax(-1), want[name].argmax(-1))


def _stub_timer(monkeypatch, seen: list, unreliable=()):
    def fake_interleaved(targets, **kw):
        seen.append(sorted(targets))
        for fn, args in targets.values():  # every target runs
            fn(*args)
        return {name: {"t": 1e-3 * (2 if name == "f32-strict" else 1),
                       "median": 1e-3, "samples": [1e-3], "spread": 0.0,
                       "unreliable": name in unreliable}
                for name in targets}

    monkeypatch.setattr(suite, "time_fns_marginal_interleaved", fake_interleaved)


def _run(capsys, **kw):
    headline.main(batch=4, width=16, iters=2, repeats=2, device="cpu", **kw)
    out = capsys.readouterr()
    return [l for l in out.out.splitlines() if l.strip()], out.err


def test_record_default(monkeypatch, capsys):
    seen = []
    _stub_timer(monkeypatch, seen)
    lines, err = _run(capsys)
    assert seen == [["f32-strict", "int8"]]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == RECORD_KEYS and tuple(rec) == headline.RECORD_KEYS
    assert rec["vs_baseline"] == pytest.approx(2.0)  # t_f32 / t_int8
    assert rec["value"] == pytest.approx(4000.0)
    assert rec["baseline_f32_ips"] == pytest.approx(2000.0)
    assert rec["ms_per_batch"] == pytest.approx(1.0)
    assert rec["unit"] == "images/s" and rec["repeats"] == 2
    assert "int8" in rec["metric"] and "TF32 off" in rec["metric"]
    assert rec["metric"].endswith("cpu (torch CPU ops: not a device measurement)")
    assert "[detail]" not in err


@pytest.mark.parametrize("flagged", [("int8",), ("f32-strict",)])
def test_record_unreliable_only_when_flagged(monkeypatch, capsys, flagged):
    _stub_timer(monkeypatch, [], unreliable=flagged)
    lines, _ = _run(capsys)
    rec = json.loads(lines[0])
    assert rec["unreliable"] is True
    assert set(rec) == RECORD_KEYS | {"unreliable"}


def test_full_times_four_targets_in_one_group(monkeypatch, capsys):
    seen = []
    _stub_timer(monkeypatch, seen)
    lines, err = _run(capsys, full=True)
    assert seen == [["f32-strict", "int8", "popcount", "tf32"]]
    assert len(lines) == 1 and set(json.loads(lines[0])) == RECORD_KEYS
    assert "[detail] tf32:" in err and "[detail] popcount:" in err
    assert "int8 vs TF32 baseline: 1.00x" in err


def test_small_real_run_prints_one_record(capsys):
    """A real run on the CPU, as tests/test_bench_modules.py runs bench.py:
    only the structure is checked (CPU times are no device's)."""
    ips, ratio = headline.main(batch=8, width=16, iters=4, repeats=2, device="cpu")
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert RECORD_KEYS <= set(rec) <= RECORD_KEYS | {"unreliable"}
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert ips > 0 and ratio > 0


@pytest.mark.parametrize("argv,want", [
    (["bench"], dict(batch=1024, width=128, iters=32, repeats=5, full=False,
                     device="cuda")),
    (["bench", "headline"], dict(batch=1024, width=128, iters=32, repeats=5,
                                 full=False, device="cuda")),
    (["bench", "--full", "--batch", "8", "--device", "cpu"],
     dict(batch=8, width=128, iters=32, repeats=5, full=True, device="cpu")),
    (["bench", "headline", "--full", "--width", "32", "--iters", "4",
      "--repeats", "3"], dict(batch=1024, width=32, iters=4, repeats=3,
                              full=True, device="cuda")),
])
def test_cli_routes_to_the_headline(monkeypatch, argv, want):
    calls = []
    monkeypatch.setattr(headline, "main", lambda **kw: calls.append(kw))
    assert cli.main(argv) == 0
    assert calls == [want]

