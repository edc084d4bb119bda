"""The port's command line (`plangen_tpu_torch/cli.py`) on the CPU.

  * `load_config` equals the JAX package's on the same arguments (config
    files of the repo, `--opt` overrides, dict flows);
  * `serve` and `train` without a card exit non-zero; `serve --device cpu`
    parses, builds the pipeline on the CPU in the serving form and hands
    it to the server; `train --device cpu` takes a step;
  * `--version`, `doctor`, and the commands not ported.
"""

import dataclasses
import json

import pytest
import torch

from plangen_tpu.cli import load_config as jload_config
from plangen_tpu_torch import __version__
from plangen_tpu_torch import cli
from plangen_tpu_torch.config import PlanGenConfig

CASES = [
    (None, []),
    ("configs/toy_smoke.py", []),
    ("configs/uni_text_ump_oimsam.py", ["train.max_train_steps=5", "generation.quantize=auto"]),
    (None, ['train.train_data=[{"task_type":"uni","data_name":"toy","batch_size":2}]',
            'train.test_data={"task_type":"plan","data_name":"toy","batch_size":1}',
            "generation.max_new_text_tokens=8", "janus_path=/nowhere"]),
]


@pytest.mark.parametrize("cfg_path,opts", CASES, ids=["defaults", "toy_smoke", "recipe", "opts"])
def test_load_config_equals_jax(cfg_path, opts):
    got = cli.load_config(cfg_path, list(opts))
    want = jload_config(cfg_path, list(opts))
    assert isinstance(got, PlanGenConfig)
    assert type(got.train.train_data[0]).__module__ == "plangen_tpu_torch.config"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--version"])
    assert e.value.code == 0
    assert __version__ in capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["serve", "train"])
def test_without_a_card_exits_non_zero(cmd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main([cmd])
    assert e.value.code not in (0, None) and "--device cpu" in str(e.value.code)


def test_serve_on_the_cpu_builds_the_serving_pipeline(monkeypatch):
    import plangen_tpu_torch.serve as serve_mod

    seen = {}

    class Stub:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            seen["served"] = True

        def server_close(self):
            pass

    def make_server(batcher, host, port):
        seen.update(batcher=batcher, host=host, port=port)
        return Stub()

    monkeypatch.setattr(serve_mod, "make_server", make_server)
    cli.main(["serve", "--device", "cpu", "--cfg", "configs/toy_smoke.py", "--port", "0",
              "--max-batch", "4", "--opt", "generation.max_new_text_tokens=4"])
    pipe = seen["batcher"].pipe
    assert seen["served"] and seen["port"] == 0 and seen["batcher"].max_batch == 4
    assert pipe.device.type == "cpu" and pipe.defer_fetch and pipe.gen.output_uint8
    assert seen["batcher"]._stop.is_set()  # closed when serving ended


def test_train_on_the_cpu_takes_a_step(tmp_path, capsys):
    cli.main(["train", "--device", "cpu", "--cfg", "configs/toy_smoke.py", "--max-steps", "1",
              "--opt", f"train.output_dir={tmp_path}",
              'train.train_data=[{"task_type":"uni","data_name":"toy","batch_size":2}]'])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final"]
    assert final["loss"] > 0


def test_doctor_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--cfg", "configs/toy_smoke.py"])
    assert e.value.code == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is False and report["checks"]["card"]["ok"] is False
    assert report["checks"]["config"]["ok"] is True


@pytest.mark.parametrize("cmd", ["eval", "metrics", "convert", "export"])
def test_commands_not_ported_raise(cmd):
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main([cmd])
