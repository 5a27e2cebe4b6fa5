"""``python -m qnx_torch`` (qnx_torch.__main__), the port of the JAX CLI:
``convert --h5`` then ``serve`` on a small MLP, the engine dispatch of
``_pack_for_engine`` against the JAX golden, the artifact round trip of
every engine's model type, and the commands that wait for later items.
Everything runs with ``--device cpu`` / ``device="cpu"``."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from engine_test_utils import MLP_CF, VGG_CF, train_golden
from qnx_torch import __main__ as cli
from qnx_torch.convert.keras_h5 import write_legacy_h5
from qnx_torch.models.factory import init_variables
from qnx_torch.nn import int8_engine as E
from qnx_torch.nn import inference as I
from qnx_torch.serve.engine import ServeEngine, normalize_u8
from qnx_torch.utils import config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = config.Config(dataset="digits", architecture="mlp", dim=64,
                     num_hidden=2, network_type="full-bnn", H=1.0)
TNN2 = dict(network_type="full-tnn", wbits=2, abits=2)

# (config, engine, the model type _pack_for_engine must return)
ENGINES = {
    "mlp-bnn-packed": (MLP_CF, "packed", I.PackedMLP),
    "mlp-tnn-packed": (MLP_CF.replace(network_type="full-tnn", wbits=2),
                       "packed", I.PackedMLP),
    "vgg-bnn-packed": (VGG_CF, "packed", I.PackedVGG),
    "vgg-tnn-abits1-packed": (VGG_CF.replace(network_type="full-tnn", wbits=2),
                              "packed", I.PackedVGG),
    "vgg-tnn-abits2-packed": (VGG_CF.replace(**TNN2), "packed", I.PlaneVGG),
    "mlp-bnn-int8": (MLP_CF, "int8", E.I8MLP),
    "vgg-bnn-int8": (VGG_CF, "int8", E.I8VGG),
    "vgg-tnn-abits2-int8": (VGG_CF.replace(**TNN2), "int8", E.I8VGG),
    "vgg-qnn-relu-int8": (VGG_CF.replace(network_type="qnn", wbits=4), "int8",
                          E.I8VGG),
}


def _mlp_h5(path, variables, cf):
    """The MLP's variables in the reference's legacy h5 layout."""
    p, s = variables["params"], variables["batch_stats"]
    layers = []
    names = [f"dense_{i}" for i in range(cf.num_hidden)] + ["dense_out"]
    bns = [f"bn_{i}" for i in range(cf.num_hidden)] + ["bn_out"]
    for i, (dn, bn) in enumerate(zip(names, bns)):
        layers.append((f"binary_dense_{i + 1}", [
            (f"{dn}/{k}:0", p[dn][k]) for k in ("kernel", "bias") if k in p[dn]]))
        layers.append((f"batch_normalization_{i + 1}", [
            (f"{bn}/gamma:0", p[bn]["scale"]), (f"{bn}/beta:0", p[bn]["bias"]),
            (f"{bn}/moving_mean:0", s[bn]["mean"]),
            (f"{bn}/moving_variance:0", s[bn]["var"])]))
    write_legacy_h5(str(path), layers)


def _u8(n, shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, *shape), np.uint8)


@pytest.fixture
def tiny_preset(monkeypatch):
    """A small MLP preset for ``--config`` (the shipped presets are full
    width)."""
    monkeypatch.setitem(config.CONFIGS, "tiny-mlp", TINY)
    return "tiny-mlp"


@pytest.mark.parametrize("engine,model_type", [("int8", E.I8MLP),
                                               ("packed", I.PackedMLP)])
def test_convert_h5_then_serve(tmp_path, capsys, tiny_preset, engine,
                               model_type):
    h5 = tmp_path / "ref.h5"
    _mlp_h5(h5, init_variables(TINY, seed=0), TINY)
    out = str(tmp_path / f"{engine}.pt")
    assert cli.main(["convert", "--h5", str(h5), "--config", tiny_preset,
                     "--engine", engine, "--out", out, "--device", "cpu"]) == 0
    art = cli.load_artifact(out, "cpu")
    assert art["engine"] == engine
    assert isinstance(art["model"], model_type)
    capsys.readouterr()
    assert cli.main(["serve", "--model", out, "--batch-size", "32",
                     "--requests", "64", "--input-shape", "8,8,1",
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert '"images": 64' in printed
    stats = json.loads(printed)
    assert stats["batches"] == 2 and stats["launches"] == {}


def test_artifact_records_engine_and_config(tmp_path, tiny_preset):
    h5 = tmp_path / "ref.h5"
    _mlp_h5(h5, init_variables(TINY, seed=1), TINY)
    out = str(tmp_path / "m.pt")
    cli.main(["convert", "--h5", str(h5), "--config", tiny_preset,
              "--engine", "packed", "--out", out, "--device", "cpu"])
    art = torch.load(out, weights_only=False)
    assert art["format"] == cli.ARTIFACT_FORMAT
    assert art["version"] == cli.ARTIFACT_VERSION
    assert art["engine"] == "packed"
    assert art["config"] == dataclasses.asdict(TINY)


def test_serve_through_python_m(tmp_path):
    """The real entry point, ``python -m qnx_torch serve``, in a process of
    its own."""
    model = cli._pack_for_engine(init_variables(TINY, seed=2), TINY, "int8",
                                 "cpu")
    out = str(tmp_path / "m.pt")
    cli.save_artifact(out, model, TINY, "int8")
    proc = subprocess.run(
        [sys.executable, "-m", "qnx_torch", "serve", "--model", out,
         "--batch-size", "16", "--requests", "40", "--input-shape", "8,8,1",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout)
    assert (stats["images"], stats["batches"]) == (40, 3)
    assert stats["pad_fraction"] == 8 / 48


def test_serve_answers_as_the_direct_forward(tmp_path, capsys):
    """serve's requests are RandomState(0) uint8 images, as the JAX CLI's;
    served through the CLI's forward they give the module's logits."""
    model = cli._pack_for_engine(init_variables(TINY, seed=3), TINY, "packed",
                                 "cpu")
    reqs = np.random.RandomState(0).randint(0, 256, (32, 8, 8, 1), np.uint8)
    with ServeEngine(model, batch_size=32,
                     forward=cli._engine_forward(model)) as eng:
        got = eng.predict(reqs)
    want = I.mlp_forward(model, normalize_u8(torch.from_numpy(reqs))).numpy()
    np.testing.assert_array_equal(got, want)


def test_packed_engine_dispatch_reaches_bitplane():
    """--engine packed on an abits>1 VGG resolves to the bit-plane engine,
    whose argmax equals the JAX fake-quant golden's (tests/test_cli_top.py)."""
    cf = VGG_CF.replace(**TNN2)
    ds, variables, gold = train_golden(cf, (32, 32, 3))
    variables = {c: {n: {k: np.asarray(v) for k, v in leaves.items()}
                     for n, leaves in variables[c].items()} for c in variables}
    model = cli._pack_for_engine(variables, cf, "packed", "cpu")
    assert isinstance(model, I.PlaneVGG)
    out = cli._engine_forward(model)(model, torch.from_numpy(ds.x_test))
    np.testing.assert_array_equal(out.numpy().argmax(-1), gold.argmax(-1))


@pytest.mark.parametrize("name", list(ENGINES))
def test_artifact_round_trip(tmp_path, name):
    """Every engine's model type: the loaded artifact's buffers and logits
    equal the in-memory module's, it has buffers (the engine takes its
    device from them), and it serves through the CLI's forward."""
    cf, engine, model_type = ENGINES[name]
    model = cli._pack_for_engine(init_variables(cf, seed=4), cf, engine, "cpu")
    assert type(model) is model_type
    out = str(tmp_path / "m.pt")
    cli.save_artifact(out, model, cf, engine)
    loaded = cli.load_artifact(out, "cpu")["model"]
    assert type(loaded) is model_type
    sa, sb = model.state_dict(), loaded.state_dict()
    assert list(sa) == list(sb) and sa
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
        assert sa[k].stride() == sb[k].stride(), k
    u8 = _u8(8, cf.input_shape, seed=5)
    x = normalize_u8(torch.from_numpy(u8))
    fwd = cli._engine_forward(model)
    want = fwd(model, x).numpy()
    np.testing.assert_array_equal(cli._engine_forward(loaded)(loaded, x).numpy(),
                                  want)
    with ServeEngine(loaded, batch_size=8, forward=fwd) as eng:
        np.testing.assert_array_equal(eng.predict(u8), want)


def test_artifact_saved_on_the_card_loads_on_the_cpu(tmp_path, monkeypatch):
    """An artifact whose tensors were saved on a CUDA device loads with
    ``map_location="cpu"``.  Without a card, the CUDA location tag is written
    by tagging every storage ``cuda:0`` at save time."""
    model = cli._pack_for_engine(init_variables(TINY, seed=6), TINY, "packed",
                                 "cpu")
    out = str(tmp_path / "cuda.pt")
    with monkeypatch.context() as m:
        m.setattr(torch.serialization, "location_tag", lambda storage: "cuda:0")
        cli.save_artifact(out, model, TINY, "packed")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch.load(out, weights_only=False)
    loaded = cli.load_artifact(out, "cpu")["model"]
    assert all(t.device.type == "cpu" for t in loaded.buffers())
    x = normalize_u8(torch.from_numpy(_u8(4, (8, 8, 1))))
    np.testing.assert_array_equal(loaded(x).numpy(), model(x).numpy())


def test_load_artifact_rejects_other_files(tmp_path):
    path = str(tmp_path / "other.pt")
    torch.save({"weights": torch.zeros(2)}, path)
    with pytest.raises(SystemExit, match="not a"):
        cli.load_artifact(path, "cpu")
    torch.save({"format": cli.ARTIFACT_FORMAT, "version": 99}, path)
    with pytest.raises(SystemExit, match="version 99"):
        cli.load_artifact(path, "cpu")


def test_engine_forward_rejects_unknown_models():
    with pytest.raises(SystemExit, match="unknown model artifact type"):
        cli._engine_forward(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("argv,item", [
    (["train", "--config", "mnist-bnn", "--device", "cuda"], "item 12"),
    (["eval", "--ckpt", "x", "--device", "cuda"], "item 12"),
    (["convert", "--ckpt", "x", "--config", "mnist-bnn", "--out", "y",
      "--device", "cpu"], "item 12"),
    (["bench", "suite"], "item 15"),
    (["bench", "scaling"], "item 15"),
    (["bench"], "item 6"),
])
def test_unported_commands_name_their_roadmap_item(argv, item, capsys, tmp_path):
    """Every command once refused naming its ROADMAP item is ported and no
    longer names it: train, eval and convert --ckpt (item 12), bench suite
    and scaling (item 15) and bench, the headline (item 6), stop here at
    the missing card or the missing checkpoint (train's output directory
    under ``tmp_path``, never the checkout)."""
    if argv[0] == "train":
        argv = [*argv, "--out", str(tmp_path / "run")]
    with pytest.raises((RuntimeError, FileNotFoundError)) as err:
        cli.main(argv)
    assert item not in str(err.value)
    if argv == ["bench"]:  # it reached the headline, which wants the card
        assert "CUDA" in str(err.value)


def test_unknown_command_exits():
    with pytest.raises(SystemExit, match="unknown command: frobnicate"):
        cli.main(["frobnicate"])


def test_help_prints_the_usage(capsys):
    assert cli.main(["--help"]) == 0
    assert "python -m qnx_torch serve" in capsys.readouterr().out


def test_bench_roofline_runs_the_ports_roofline(monkeypatch):
    import qnx_torch.bench.roofline as roofline

    seen = []
    monkeypatch.setattr(roofline, "main", lambda device: seen.append(device))
    assert cli.main(["bench", "roofline", "--device", "cpu"]) == 0
    assert seen == ["cpu"]


def test_the_card_is_the_default(tmp_path, tiny_preset):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    h5 = tmp_path / "ref.h5"
    _mlp_h5(h5, init_variables(TINY, seed=7), TINY)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["convert", "--h5", str(h5), "--config", tiny_preset,
                  "--out", str(tmp_path / "m.pt")])
    out = str(tmp_path / "cpu.pt")
    cli.main(["convert", "--h5", str(h5), "--config", tiny_preset, "--out", out,
              "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["serve", "--model", out, "--input-shape", "8,8,1"])


def test_convert_needs_h5(tiny_preset):
    with pytest.raises(SystemExit):
        cli.main(["convert", "--config", tiny_preset, "--out", "x",
                  "--device", "cpu"])
