"""The port's weight artifacts on the CPU (`tiny`, fp32): `cli convert` and
`params_path` (`convert/params.py`), `cli export` (`convert/export.py`),
`PlanGenCheckpointer.save_params_only` and the `Trainer` from an artifact.

  * `convert` plain and in each quantized form, then `load_params`:
    every tensor bitwise equal to the checkout's model (quantized: to that
    model quantized in place), the scales fp32 in any load dtype; the
    pipeline serves an int4 artifact in its form without quantizing again;
    an `--out` holding anything but an artifact is refused and kept;
  * `export`, full and `--trainable` in every tuning mode, in all three
    file formats: bitwise equal to the JAX package's `export_state_dict` /
    `export_trainable_state_dict` on the same weights; the port's tree
    exporter is equal to JAX's too; a quantized source exits with JAX's
    message;
  * `save_params_only` (whole and masked), LoRA adapters through an
    artifact, and the `Trainer` starting from a dense artifact.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plangen_tpu.config import PlanGenModelConfig as JaxModelConfig
from plangen_tpu.convert.jax_to_torch import export_state_dict as jexport
from plangen_tpu.convert.jax_to_torch import export_trainable_state_dict as jexport_trainable
from plangen_tpu.convert.jax_to_torch import save_torch_state_dict as jsave
from plangen_tpu.models import vlm as jvlm
from plangen_tpu.train import lora as jlora
from plangen_tpu_torch import cli
from plangen_tpu_torch.config import (
    FlowConfig, GenerationConfig, PlanGenConfig, PlanGenModelConfig, apply_overrides,
)
from plangen_tpu_torch.convert import load_jax_params, safetensors
from plangen_tpu_torch.convert import export as texport
from plangen_tpu_torch.convert import params as artifact
from plangen_tpu_torch.convert.loading import load_params
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.ops.quant import quant_form, quantize_model_, quantized_structure_
from plangen_tpu_torch.tasks.eval import build_pipeline
from plangen_tpu_torch.train.checkpoint import PlanGenCheckpointer
from plangen_tpu_torch.train.lora import has_lora
from plangen_tpu_torch.train.optim import trainable_mask

TINY = PlanGenModelConfig.tiny()
TOY_CFG = str(pathlib.Path(__file__).resolve().parent.parent / "configs" / "toy_smoke.py")
MODES = ("all", "lm", "stage1", "stage2", "stage3", "lora", "lora_tokens")
FORMATS = (".pth", ".safetensors", ".npz")


@functools.lru_cache(maxsize=None)
def _jax_params():
    params = jvlm.init(jax.random.PRNGKey(5), JaxModelConfig.tiny(), dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The seeded JAX weights as an HF checkout (the JAX exporter's .bin)."""
    path = tmp_path_factory.mktemp("janus")
    jsave(jexport(_jax_params(), JaxModelConfig.tiny()), str(path / "pytorch_model.bin"))
    return path


def _checkout_model(checkout, dtype=torch.float32):
    return load_params(PlanGenConfig(model=TINY, janus_path=str(checkout)), dtype=dtype)


def _convert(checkout, out, capsys, *extra):
    cli.main(["convert", "--device", "cpu", "--cfg", TOY_CFG, "--janus-path", str(checkout),
              "--out", str(out), *extra])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("quantize", [None, "int8", "int4", "int4_a8"])
def test_convert_round_trips_bit_for_bit(checkout, tmp_path, capsys, quantize):
    extra = [] if quantize is None else ["--quantize", quantize]
    printed = _convert(checkout, tmp_path / "art", capsys, *extra)
    assert sorted(printed) == ["params_m", "saved"]
    assert printed["saved"] == str((tmp_path / "art").resolve())
    meta = json.loads((tmp_path / "art" / artifact.META).read_text())
    assert meta == {"format": artifact.FORMAT, "version": artifact.VERSION,
                    "quantize": quantize}
    want = _checkout_model(checkout)
    if quantize is not None:
        quantize_model_(want, quantize, eager=True)  # convert's rule: JAX's eager one
    got = load_params(PlanGenConfig(model=TINY, params_path=printed["saved"]),
                      dtype=torch.float32)
    assert quant_form(got) == quant_form(want)
    _assert_state_equal(got.state_dict(), want.state_dict())
    n = sum(t.numel() for t in want.state_dict().values())
    assert printed["params_m"] == round(n / 1e6, 1)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_a_quantized_artifact_keeps_fp32_scales_in_bf16(checkout, tmp_path, capsys,
                                                        quantize):
    path = _convert(checkout, tmp_path / "art", capsys, "--quantize", quantize)["saved"]
    f32 = load_params(PlanGenConfig(model=TINY, params_path=path), dtype=torch.float32)
    bf16 = load_params(PlanGenConfig(model=TINY, params_path=path), dtype=torch.bfloat16)
    # a bf16 model of the same form: the dtype each tensor takes (the VQ
    # codebook stays fp32 in any model)
    ref = quantized_structure_(PlanGenModel(TINY, dtype=torch.bfloat16), quantize).state_dict()
    n_scales = 0
    for k, v in bf16.state_dict().items():
        want = f32.state_dict()[k]
        if k.rsplit(".", 1)[-1] in ("scale", "s_lo", "s_hi16"):
            assert v.dtype == torch.float32, k
            n_scales += 1
        assert v.dtype == ref[k].dtype, k
        torch.testing.assert_close(v, want.to(v.dtype), rtol=0, atol=0)
    assert n_scales > 0 and bf16.state_dict()["gen_embed.weight"].dtype == torch.bfloat16


def test_the_pipeline_serves_an_int4_artifact_in_its_form(checkout, tmp_path, capsys,
                                                          monkeypatch):
    from plangen_tpu_torch.ops import quant

    path = _convert(checkout, tmp_path / "art", capsys, "--quantize", "int4")["saved"]
    gen = GenerationConfig(max_new_text_tokens=4)
    quantized = []
    inner = quant.quantize_model_
    monkeypatch.setattr("plangen_tpu_torch.tasks.pipeline.quantize_model_",
                        lambda *a: (quantized.append(a[1]), inner(*a))[1])
    pipe = build_pipeline(PlanGenConfig(model=TINY, params_path=path, generation=gen,
                                        param_dtype="float32"), device="cpu")
    assert quantized == [] and pipe.gen.quantize == "int4" and pipe._quantized_cache
    in_place = build_pipeline(PlanGenConfig(
        model=TINY, janus_path=str(checkout), param_dtype="float32",
        generation=GenerationConfig(max_new_text_tokens=4, quantize="int4")), device="cpu")
    assert quantized == ["int4"]
    captions = ["two cats", "a red fox"]
    assert pipe.plan(captions) == in_place.plan(captions)


def test_convert_applies_the_finetune_overlay(checkout, tmp_path, capsys):
    base = _checkout_model(checkout).state_dict()
    overlay = {"vl_gpt.gen_embed.weight": base["gen_embed.weight"] * 3 - 1}
    torch.save(overlay, tmp_path / "trainable_model_parameters.pth")
    path = _convert(checkout, tmp_path / "art", capsys, "--finetune",
                    str(tmp_path / "trainable_model_parameters.pth"))["saved"]
    got = load_params(PlanGenConfig(model=TINY, params_path=path), dtype=torch.float32)
    torch.testing.assert_close(got.state_dict()["gen_embed.weight"],
                               overlay["vl_gpt.gen_embed.weight"], rtol=0, atol=0)


def test_an_int4_artifact_in_bf16_is_the_in_place_bf16_form(checkout, tmp_path, capsys):
    """A checkout of bf16 weights (as released): converted in fp32 and
    quantized from it, then loaded in bf16, the artifact is bitwise the bf16
    load quantized in place (quantization runs in fp32 from either)."""
    bf16 = tmp_path / "bf16"
    bf16.mkdir()
    sd = _checkout_model(checkout, torch.bfloat16).state_dict()
    torch.save(sd, bf16 / "pytorch_model.bin")
    path = _convert(bf16, tmp_path / "art", capsys, "--quantize", "int4")["saved"]
    stored = safetensors.load_file(str(pathlib.Path(path) / artifact.WEIGHTS))
    assert stored["gen_embed.weight"].dtype == torch.float32
    got = load_params(PlanGenConfig(model=TINY, params_path=path), dtype=torch.bfloat16)
    want = quantize_model_(_checkout_model(bf16, torch.bfloat16), "int4", eager=True)
    _assert_state_equal(got.state_dict(), want.state_dict())


@pytest.mark.parametrize("where", ["a directory with a file", "the checkout itself"])
def test_convert_refuses_an_out_that_is_not_an_artifact(checkout, tmp_path, capsys, where):
    """As orbax refuses an existing destination: nothing at --out is lost."""
    if where == "the checkout itself":
        out = tmp_path / "janus"
        out.mkdir()
        (out / "pytorch_model.bin").write_bytes((checkout / "pytorch_model.bin").read_bytes())
        janus = out
    else:
        out, janus = tmp_path / "models", checkout
        out.mkdir()
        (out / "notes.txt").write_text("keep me")
    before = {f.name: f.read_bytes() for f in out.iterdir()}
    with pytest.raises(SystemExit) as e:
        _convert(janus, out, capsys)
    assert "not an artifact" in str(e.value.code)
    assert {f.name: f.read_bytes() for f in out.iterdir()} == before


def test_convert_replaces_an_empty_directory_or_an_artifact(checkout, tmp_path, capsys):
    out = tmp_path / "art"
    out.mkdir()
    _convert(checkout, out, capsys, "--quantize", "int8")
    printed = _convert(checkout, out, capsys)
    assert sorted(p.name for p in out.iterdir()) == sorted([artifact.META, artifact.WEIGHTS])
    assert [p.name for p in tmp_path.iterdir()] == ["art"]  # no temporary left
    got = load_params(PlanGenConfig(model=TINY, params_path=printed["saved"]),
                      dtype=torch.float32)
    assert quant_form(got) is None


def test_save_params_refuses_a_directory_with_more_than_an_artifact(checkout, tmp_path):
    model = _checkout_model(checkout)
    path = artifact.save_params(model, str(tmp_path / "art"))
    (tmp_path / "art" / "extra.bin").write_bytes(b"\0")
    with pytest.raises(FileExistsError, match="not an artifact"):
        artifact.save_params(model, path)
    assert (tmp_path / "art" / "extra.bin").exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["art"]


def test_an_orbax_directory_still_raises(tmp_path):
    (tmp_path / "_METADATA").write_text("{}")
    (tmp_path / "manifest.ocdbt").write_bytes(b"\0")
    with pytest.raises(NotImplementedError, match="orbax"):
        load_params(PlanGenConfig(model=TINY, params_path=str(tmp_path)))


def test_another_format_raises(tmp_path):
    (tmp_path / artifact.META).write_text(json.dumps({"format": "x", "version": 1}))
    with pytest.raises(ValueError, match="format"):
        load_params(PlanGenConfig(model=TINY, params_path=str(tmp_path)))


# ------------------------------------------------------------------ export


def _read(path):
    if path.endswith(".pth"):
        return {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        back = load_file(path)  # the package's reader agrees with the port's
        port = safetensors.load_file(path)
        assert sorted(back) == sorted(port)
        for k in back:
            np.testing.assert_array_equal(back[k], port[k].numpy())
        return back
    return dict(np.load(path))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", (None,) + MODES)
def test_cli_export_equals_jax(checkout, tmp_path, capsys, mode, fmt):
    out = str(tmp_path / f"sd{fmt}")
    argv = ["export", "--device", "cpu", "--cfg", TOY_CFG, "--opt",
            f"janus_path={checkout}", "--out", out]
    cli.main(argv + ([] if mode is None else ["--trainable", mode]))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(printed) == ["dtype", "keys", "params_m", "saved", "trainable"]
    want = (jexport(_jax_params(), JaxModelConfig.tiny()) if mode is None
            else jexport_trainable(_jax_params(), JaxModelConfig.tiny(), mode))
    got = _read(out)
    assert printed["keys"] == len(want) and printed["trainable"] == mode
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("mode", (None,) + MODES)
def test_tree_exporter_equals_jax(mode):
    params = _jax_params()
    if mode is None:
        got = texport.export_state_dict(params, TINY)
        want = jexport(params, JaxModelConfig.tiny())
    else:
        got = texport.export_trainable_state_dict(params, TINY, mode, prefix="")
        want = jexport_trainable(params, JaxModelConfig.tiny(), mode, prefix="")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_export_merges_lora_as_jax_does():
    """Adapters with B != 0: the merged q/k/v/o of the model and of the tree
    equal JAX's merge within fp32 rounding (the products sum in another
    order), and the adapters themselves are not exported."""
    cfg = JaxModelConfig.tiny()
    tree = jlora.init_lora(jax.random.PRNGKey(6), cfg.llama, rank=4, alpha=8)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rs = np.random.RandomState(0)
    for t in ("q_proj", "k_proj", "v_proj", "o_proj"):
        tree[t]["b"] = rs.normal(0, 0.1, tree[t]["b"].shape).astype(np.float32)
    params = jlora.add_lora(_jax_params(), tree)
    want = jexport_trainable(params, cfg, "lora_tokens")
    model = PlanGenModel(TINY, dtype=torch.float32)
    load_jax_params(model, params, TINY)
    assert has_lora(model)
    for got in (texport.model_state_dict(model, "lora_tokens"),
                texport.export_trainable_state_dict(params, TINY, "lora_tokens")):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    assert has_lora(model)  # merged on a copy


def test_export_of_a_quantized_artifact_exits_with_the_jax_message(checkout, tmp_path,
                                                                  capsys):
    path = _convert(checkout, tmp_path / "art", capsys, "--quantize", "int4")["saved"]
    with pytest.raises(SystemExit) as e:
        cli.main(["export", "--device", "cpu", "--cfg", TOY_CFG, "--opt",
                  f"params_path={path}", "--out", str(tmp_path / "sd.pth")])
    assert "export: cannot export a quantized" in str(e.value.code)
    assert "WITHOUT --quantize" in str(e.value.code)


@pytest.mark.parametrize("extra,match", [
    (["--trainable", "nope"], "unknown tuning_mode"),
    (["--out", "sd.txt"], "unsupported export extension"),
])
def test_export_refusals_exit(checkout, tmp_path, extra, match):
    argv = ["export", "--device", "cpu", "--cfg", TOY_CFG, "--opt", f"janus_path={checkout}",
            "--out", str(tmp_path / "sd.pth")]
    if extra[0] == "--out":
        argv[-1] = str(tmp_path / extra[1])
        extra = []
    with pytest.raises(SystemExit) as e:
        cli.main(argv + extra)
    assert match in str(e.value.code)


def test_export_without_weights_exits(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["export", "--device", "cpu", "--cfg", TOY_CFG, "--out",
                  str(tmp_path / "sd.pth")])
    assert "no weights configured" in str(e.value.code)


def test_convert_and_export_without_a_card_exit_non_zero(checkout, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["convert", "--janus-path", str(checkout), "--out", str(tmp_path / "a")],
                 ["export", "--out", str(tmp_path / "sd.pth")]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert "--device cpu" in str(e.value.code)


# -------------------------------------------------------- save_params_only


def test_save_params_only_round_trips(checkout, tmp_path):
    model = _checkout_model(checkout)
    ckpt = PlanGenCheckpointer(str(tmp_path / "ckpt"))
    path = ckpt.save_params_only(7, model)
    assert path == str(tmp_path / "ckpt" / "params-7") and ckpt.all_steps() == []
    got = load_params(PlanGenConfig(model=TINY, params_path=path), dtype=torch.float32)
    _assert_state_equal(got.state_dict(), model.state_dict())


def test_save_params_only_with_a_mask_keeps_the_masked_part(checkout, tmp_path):
    model = _checkout_model(checkout)
    mask = trainable_mask(model, "stage1")
    path = PlanGenCheckpointer(str(tmp_path)).save_params_only(1, model, mask)
    stored = safetensors.load_file(str(pathlib.Path(path) / artifact.WEIGHTS))
    assert sorted(stored) == sorted(k for k, keep in mask.items() if keep)
    with pytest.raises(KeyError, match="lacks"):
        load_params(PlanGenConfig(model=TINY, params_path=path))


def test_lora_adapters_go_through_an_artifact(tmp_path):
    cfg = JaxModelConfig.tiny()
    tree = jax.tree_util.tree_map(np.asarray,
                                  jlora.init_lora(jax.random.PRNGKey(2), cfg.llama, rank=4))
    model = PlanGenModel(TINY, dtype=torch.float32)
    load_jax_params(model, jlora.add_lora(_jax_params(), tree), TINY)
    path = artifact.save_params(model, str(tmp_path / "art"))
    got = load_params(PlanGenConfig(model=TINY, params_path=path), dtype=torch.float32)
    assert has_lora(got)
    _assert_state_equal(got.state_dict(), model.state_dict())


# ----------------------------------------------------------------- trainer


def _train_cfg(tmp_path, params_path):
    return apply_overrides(PlanGenConfig(model=TINY, janus_hw=32, params_path=params_path), {
        "train.train_data": (FlowConfig("uni", "toy", 2), FlowConfig("plan", "toy", 2)),
        "train.output_dir": str(tmp_path / "run"),
        "train.num_workers": 0,
        "train.prefetch_depth": 0,
    })


def test_trainer_starts_from_a_dense_artifact(checkout, tmp_path, capsys):
    from plangen_tpu_torch.train.trainer import Trainer

    path = _convert(checkout, tmp_path / "art", capsys)["saved"]
    trainer = Trainer(_train_cfg(tmp_path, path), device="cpu")
    _assert_state_equal(trainer.model.state_dict(), _checkout_model(checkout).state_dict())


def test_trainer_refuses_a_quantized_artifact(checkout, tmp_path, capsys):
    from plangen_tpu_torch.train.trainer import Trainer

    path = _convert(checkout, tmp_path / "art", capsys, "--quantize", "int8")["saved"]
    with pytest.raises(ValueError, match="dense weights"):
        Trainer(_train_cfg(tmp_path, path), device="cpu")
