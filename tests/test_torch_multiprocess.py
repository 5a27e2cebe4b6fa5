"""The multi-process bring-up of the port (``python -m
qnx_torch.experiments.multiproc_worker``, one process a rank, gloo on the
CPU) against the port's one-process run and the JAX package's
``bringup_workloads`` on the same mesh shape, from the same JAX draws.

Tolerance, as ``tests/test_torch_train.py`` holds one step to JAX's: the
loss within 1e-6 relative; the parameters within 1e-3 lr_start each, so
the parameters' checksum within 1e-3 lr_start times the sum of its
weights; the logits checksum bit for bit between ranks and against the
one-process run.  Each rank runs under a 120 s subprocess timeout and a
90 s collective timeout."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from qnx.models.factory import init_model
from qnx.parallel.bringup import bringup_workloads as jax_bringup
from qnx.parallel.mesh import make_mesh
from qnx.train.loop import create_train_state
from qnx_torch.experiments.multiproc_worker import save_variables
from qnx_torch.parallel.bringup import (bringup_configs, bringup_workloads,
                                        checksum_weight)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("loss", "accuracy", "params_checksum", "logits_checksum")


def _jax_draws(dp, tp):
    """The JAX bring-up's initial variables: its train state's and its
    VGG's, as numpy trees."""
    cf, cf_v = bringup_configs(dp, tp)
    st = create_train_state(cf, jax.random.PRNGKey(0), steps_per_epoch=10)
    v = {"params": st.params, "quant": st.quant, "batch_stats": st.batch_stats}
    _, vv = init_model(cf_v, jax.random.PRNGKey(1))
    as_np = lambda t: jax.tree.map(np.array, jax.device_get(dict(t)))
    return cf, as_np(v), as_np(vv)


def _ranks(tmp_path, n, mp, variables, bn="global"):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-m", "qnx_torch.experiments.multiproc_worker",
         f"file://{tmp_path / f'init_{bn}'}", str(r), str(n), "--mp", str(mp),
         "--device", "cpu", "--variables", variables, "--bn", bn],
        cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank failed rc={p.returncode}\n{err[-3000:]}"
            line = [l for l in out.splitlines() if l.startswith("BRINGUP ")]
            assert line, out
            outs.append(json.loads(line[0][len("BRINGUP "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module", params=[(2, 2), (4, 2)], ids=["mesh1x2", "mesh2x2"])
def bringup(request, tmp_path_factory):
    n, mp = request.param
    mesh = make_mesh(n, model_parallel=mp)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    cf, v, vv = _jax_draws(dp, tp)
    path = str(tmp_path_factory.mktemp("vars") / "v.npz")
    save_variables(path, variables=v, vgg_variables=vv)
    return dict(
        n=n, mp=mp, dp=dp, tp=tp, cf=cf, v=v, path=path,
        tmp=tmp_path_factory.mktemp("world"),
        jax=jax_bringup(mesh),
        one=bringup_workloads(None, device="cpu", variables=v, vgg_variables=vv,
                              shape=(dp, tp)))


def _within(got: dict, want: dict, tol_params: float) -> list:
    """The keys where ``got`` is outside the one-step tolerance of ``want``."""
    bad = []
    if abs(got["loss"] - want["loss"]) > 1e-6 * abs(want["loss"]):
        bad.append("loss")
    if got["accuracy"] != want["accuracy"]:
        bad.append("accuracy")
    if abs(got["params_checksum"] - want["params_checksum"]) > tol_params:
        bad.append("params_checksum")
    return bad


def _tol(b) -> float:
    return 1e-3 * b["cf"].lr_start * checksum_weight(b["v"]["params"])


def test_bringup_ranks_agree_and_match_one_process_and_jax(bringup):
    b = bringup
    ranks = _ranks(b["tmp"], b["n"], b["mp"], b["path"])
    assert sorted(r["rank"] for r in ranks) == list(range(b["n"]))
    assert all(r["world"] == b["n"] and r["backend"] == "gloo" for r in ranks)
    assert all(r["mesh"] == [b["dp"], b["tp"]] == b["jax"]["mesh"] for r in ranks)
    for key in KEYS:  # every rank holds the same scalars, bit for bit
        assert len({r[key] for r in ranks}) == 1, key
    r0 = ranks[0]
    assert r0["logits_checksum"] == b["one"]["logits_checksum"]
    assert _within(r0, b["one"], _tol(b)) == []
    assert _within(r0, b["jax"], _tol(b)) == []
    assert abs(r0["logits_checksum"] - b["jax"]["logits_checksum"]) <= 1e-5 * abs(
        b["jax"]["logits_checksum"])


def test_per_rank_batch_norm_would_be_caught(bringup):
    """DDP without SyncBN (each data rank's own BN statistics) is not the
    JAX step: at dp 2 it lands outside the tolerance; at dp 1 it is the
    same step."""
    b = bringup
    ranks = _ranks(b["tmp"], b["n"], b["mp"], b["path"], bn="local")
    bad = _within(ranks[0], b["jax"], _tol(b))
    if b["dp"] > 1:
        assert "loss" in bad and "params_checksum" in bad
    else:
        assert bad == []
