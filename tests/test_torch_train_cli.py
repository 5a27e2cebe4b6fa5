"""Checkpoints, the metrics log and the training CLI of the port
(``qnx_torch.train.checkpoint``, ``qnx_torch.utils.metrics``,
``python -m qnx_torch train | eval | convert --ckpt``), the cases of
``tests/test_cli_checkpoint.py``; the numpy-only copies held equal to the
JAX package's; ``train --device cpu`` -> ``convert --ckpt`` -> ``eval`` and
``serve``.  Everything runs on the CPU."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qnx_torch import __main__ as cli
from qnx_torch.data import datasets
from qnx_torch.models.factory import init_model
from qnx_torch.nn import int8_engine as E
from qnx_torch.nn import inference as I
from qnx_torch.train import __main__ as train_cli
from qnx_torch.train.checkpoint import load_checkpoint, save_checkpoint
from qnx_torch.utils import config
from qnx_torch.utils.metrics import MetricsLogger, _jsonable

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CF = config.Config(dataset="digits", architecture="mlp", dim=32, num_hidden=2,
                   network_type="full-bnn", H=1.0, epochs=1, batch_size=64)
MLP_ARGS = ["--dataset", "digits", "--architecture", "mlp", "--network-type",
            "full-bnn", "--dim", "32", "--num-hidden", "2", "--batch-size", "64",
            "--h", "1.0", "--lr-start", "5e-3", "--device", "cpu"]
VGG_TNN = config.Config(dataset="synthetic-cifar", architecture="vgg", width=8,
                        dense_units=32, network_type="full-tnn", wbits=2, abits=2,
                        H=1.0, first_layer_float=True, last_layer_float=True,
                        epochs=1, batch_size=16)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _same_buffers(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        _, variables = init_model(CF, 0, "cpu")
        path = save_checkpoint(str(tmp_path / "ckpt"), variables, CF)
        restored, cf2 = load_checkpoint(path)
        assert cf2 == CF
        for c in variables:
            for n in variables[c]:
                for k, v in variables[c][n].items():
                    assert restored[c][n][k].dtype == v.dtype
                    np.testing.assert_array_equal(restored[c][n][k], v)
        assert sorted(os.listdir(tmp_path)) == ["ckpt", "ckpt.config.json"]

    def test_payload_reads_with_weights_only(self, tmp_path):
        path = save_checkpoint(str(tmp_path / "ckpt"), init_model(CF, 0, "cpu")[1], CF)
        payload = torch.load(path, weights_only=True)
        assert isinstance(payload["variables"]["params"]["dense_0"]["kernel"],
                          torch.Tensor)
        with open(path + ".config.json") as f:
            assert json.load(f) == dataclasses.asdict(CF)

    def test_checkpoint_converts(self, tmp_path):
        path = save_checkpoint(str(tmp_path / "ckpt"), init_model(CF, 0, "cpu")[1], CF)
        restored, cf2 = load_checkpoint(path)
        packed = cli._pack_for_engine(restored, cf2, "packed", "cpu")
        with torch.inference_mode():
            assert packed(torch.zeros(2, 8, 8, 1)).shape == (2, 10)


class TestMetrics:
    def test_jsonl_log(self, tmp_path):
        path = str(tmp_path / "m.jsonl")
        log = MetricsLogger(path)
        log.log(event="epoch", epoch=0, acc=np.float32(0.5),
                loss=torch.tensor(0.25), hist=torch.tensor([1.0, 2.0]))
        log.log(event="done", values=[1, 2])
        log.close()
        lines = _records(path)
        assert lines[0]["event"] == "epoch"
        assert isinstance(lines[0]["acc"], float) and lines[0]["loss"] == 0.25
        assert lines[0]["hist"] == [1.0, 2.0]
        assert lines[1]["values"] == [1, 2]

    def test_copy_equals_jax(self, tmp_path):
        """The same records as qnx.utils.metrics, but for the clock."""
        from qnx.utils import metrics as jm

        fields = dict(event="epoch", epoch=np.int64(3), acc=np.float32(0.5),
                      nested={"a": (np.float64(1.5), [np.arange(3)])}, s="x",
                      none=None)
        assert _jsonable(fields) == jm._jsonable(fields)
        recs = []
        for cls in (MetricsLogger, jm.MetricsLogger):
            p = str(tmp_path / f"{cls.__module__}.jsonl")
            log = cls(p)
            log.log(**fields)
            log.close()
            (rec,) = _records(p)
            rec.pop("t")
            recs.append(rec)
        assert recs[0] == recs[1]
        assert MetricsLogger(None).log(x=torch.tensor(2))["x"] == 2


class TestCli:
    def test_end_to_end_digits(self, tmp_path, capsys):
        out = str(tmp_path / "run")
        assert train_cli.main([*MLP_ARGS, "--epochs", "1", "--out", out,
                               "--convert", "int8"]) == 0
        names = set(os.listdir(out))
        assert {"metrics.jsonl", "model.int8.pt", "ckpt", "ckpt.config.json",
                "train_state", "train_state.config.json"} <= names
        recs = _records(os.path.join(out, "metrics.jsonl"))
        assert [r["event"] for r in recs] == ["start", "epoch", "done"]
        steps = -(-1437 // 64)
        assert len(recs[1]["train_losses"]) == steps
        assert all(np.isfinite(recs[1]["train_losses"]))
        assert recs[2]["step"] == steps
        assert isinstance(cli.load_artifact(os.path.join(out, "model.int8.pt"),
                                            "cpu")["model"], E.I8MLP)

    def test_preset_config(self):
        args = train_cli.build_argparser().parse_args(
            ["--config", "cifar10-bnn", "--epochs", "2"])
        cf = train_cli.config_from_args(args)
        assert cf.architecture == "vgg" and cf.first_layer_float and cf.epochs == 2
        assert args.device == "cuda"

    @pytest.mark.parametrize("argv", [
        ["--config", "mnist-tnn", "--h", "0.5", "--stochastic", "--dropout-rate",
         "0.1", "--lr-end", "1e-5"],
        ["--architecture", "vgg", "--width", "16", "--activation", "quantized_tanh",
         "--abits", "3", "--h", "Glorot", "--loss", "crossentropy", "--use-bias"],
        MLP_ARGS[:-2],
    ])
    def test_config_from_args_equals_jax(self, argv):
        """The JAX CLI's arguments, parsed to the same config."""
        from qnx.train import __main__ as jt

        want = jt.config_from_args(jt.build_argparser().parse_args(argv))
        got = train_cli.config_from_args(train_cli.build_argparser().parse_args(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)

    def test_takes_every_argument_of_the_jax_cli(self):
        from qnx.train import __main__ as jt

        want = {a.dest for a in jt.build_argparser()._actions}
        got = {a.dest for a in train_cli.build_argparser()._actions}
        assert want | {"device"} == got

    def test_train_convert_eval_serve(self, tmp_path, capsys):
        """``python -m qnx_torch train`` in a process of its own, then
        ``convert --ckpt`` into both engines (buffers equal to ``train
        --convert``'s), ``eval`` with the fake-quant model and both engines
        (the same accuracy at H = 1), and ``serve``."""
        out = str(tmp_path / "run")
        proc = subprocess.run(
            [sys.executable, "-m", "qnx_torch", "train", *MLP_ARGS, "--epochs",
             "2", "--out", out, "--convert", "int8"], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        acc = float(proc.stdout.split("test accuracy ")[1].split()[0])
        ckpt = os.path.join(out, "ckpt")
        for engine, model_type in (("int8", E.I8MLP), ("packed", I.PackedMLP)):
            art = str(tmp_path / f"{engine}.pt")
            assert cli.main(["convert", "--ckpt", ckpt, "--engine", engine,
                             "--out", art, "--device", "cpu"]) == 0
            model = cli.load_artifact(art, "cpu")["model"]
            assert isinstance(model, model_type)
            if engine == "int8":
                _same_buffers(model, cli.load_artifact(
                    os.path.join(out, "model.int8.pt"), "cpu")["model"])
        capsys.readouterr()
        for engine in ("fake", "int8", "packed"):
            assert cli.main(["eval", "--ckpt", ckpt, "--engine", engine,
                             "--device", "cpu"]) == 0
            line = capsys.readouterr().out
            assert line.startswith(f"digits test accuracy [{engine}]: ")
            assert float(line.split("]: ")[1].split()[0]) == pytest.approx(acc, abs=1e-4)
        assert cli.main(["serve", "--model", str(tmp_path / "packed.pt"),
                         "--batch-size", "32", "--requests", "64",
                         "--input-shape", "8,8,1", "--device", "cpu"]) == 0
        stats = json.loads(capsys.readouterr().out)
        assert stats["images"] == 64 and stats["launches"] == {}

    def test_resume_through_the_cli(self, tmp_path, capsys):
        out = str(tmp_path / "run")
        train_cli.main([*MLP_ARGS, "--epochs", "1", "--out", out])
        assert train_cli.main([*MLP_ARGS, "--epochs", "2", "--out", out,
                               "--resume"]) == 0
        recs = _records(os.path.join(out, "metrics.jsonl"))
        assert [r["event"] for r in recs] == ["start", "epoch", "done"] * 2
        assert recs[3]["resume"] and [recs[1]["epoch"], recs[4]["epoch"]] == [0, 1]
        with open(os.path.join(out, "train_state.config.json")) as f:
            sidecar = json.load(f)
        assert sidecar["epochs_done"] == 2 and sidecar["opt_steps"] == 23
        assert recs[5]["step"] == 2 * 23
        capsys.readouterr()
        train_cli.main([*MLP_ARGS, "--epochs", "2", "--out", out, "--resume"])
        assert "nothing to do" in capsys.readouterr().out

    def test_train_convert_packed_routes_abits2_vgg_to_bitplane(
            self, tmp_path, monkeypatch):
        """``train --convert packed`` of an abits-2 VGG writes the bit-plane
        engine's model, as ``convert --ckpt`` does; the JAX train CLI calls
        pack_vgg there, which refuses abits > 1 (ROADMAP.md §3)."""
        from qnx.convert.pack_model import pack_vgg as jax_pack_vgg
        from qnx.utils.config import Config as JConfig

        small = datasets.synthetic((32, 32, 3), n_train=32, n_test=16)
        monkeypatch.setattr(datasets, "load_dataset", lambda name: small)
        monkeypatch.setitem(config.CONFIGS, "tiny-vgg-tnn", VGG_TNN)
        out = str(tmp_path / "run")
        assert train_cli.main(["--config", "tiny-vgg-tnn", "--out", out,
                               "--convert", "packed", "--device", "cpu"]) == 0
        model = cli.load_artifact(os.path.join(out, "model.packed.pt"), "cpu")["model"]
        assert isinstance(model, I.PlaneVGG)
        variables, cf = load_checkpoint(os.path.join(out, "ckpt"))
        assert cf == VGG_TNN
        _same_buffers(model, cli._pack_for_engine(variables, cf, "packed", "cpu"))
        with pytest.raises(ValueError):
            jax_pack_vgg(variables, JConfig(**dataclasses.asdict(cf)))

    def test_convert_arguments(self, tmp_path):
        with pytest.raises(SystemExit):
            cli.main(["convert", "--engine", "int8", "--out", str(tmp_path / "x")])
        with pytest.raises(SystemExit):
            cli.main(["convert", "--h5", "w.h5", "--out", str(tmp_path / "x")])
        with pytest.raises(SystemExit):
            cli.main(["convert", "--h5", "w.h5", "--ckpt", "c", "--config",
                      "mnist-bnn", "--out", str(tmp_path / "x")])

    def test_commands_need_the_card_by_default(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        path = save_checkpoint(str(tmp_path / "ckpt"), init_model(CF, 0, "cpu")[1], CF)
        for argv in (["train", *MLP_ARGS[:-2], "--out", str(tmp_path / "r")],
                     ["eval", "--ckpt", path],
                     ["convert", "--ckpt", path, "--out", str(tmp_path / "m.pt")]):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                cli.main(argv)
