"""The port's weight loading against the JAX package's (`tiny`, fp32).

  * a local HF checkout written as safetensors or as `pytorch_model*.bin`
    shards, by the JAX package's exporter or by the port's, loads into a
    port model equal, tensor for tensor, to what the JAX package's
    `load_params` converts from the same directory, and the model's
    outputs equal JAX's within fp32 rounding (1e-5);
  * an extra checkpoint key is skipped and listed, a missing one raises;
  * the `finetune_path` overlay strips `vl_gpt.` and skips unmatched keys,
    as JAX's does; a `params_path` that is not the port's artifact (an
    orbax directory) raises (the artifact itself:
    tests/test_torch_artifacts.py); the `Trainer` starts from the
    loaded checkpoint in fp32;
  * the port's safetensors reader and writer against the `safetensors`
    package, every dtype they take.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.torch import load_file as st_load, save_file as st_save

from plangen_tpu.config import PlanGenConfig as JaxConfig
from plangen_tpu.config import PlanGenModelConfig as JaxModelConfig
from plangen_tpu.convert.jax_to_torch import export_state_dict as jexport
from plangen_tpu.convert.jax_to_torch import save_torch_state_dict
from plangen_tpu.convert.loading import load_params as jload_params
from plangen_tpu.models import vlm as jvlm
from plangen_tpu_torch.config import PlanGenConfig, PlanGenModelConfig
from plangen_tpu_torch.convert import safetensors
from plangen_tpu_torch.convert.export import export_state_dict
from plangen_tpu_torch.convert.loading import load_params, read_checkpoint_dir

TINY = PlanGenModelConfig.tiny()


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jvlm.init(jax.random.PRNGKey(3), JaxModelConfig.tiny(), dtype=jnp.float32)


def _write_checkpoint(path, layout):
    """An HF checkout of the seeded JAX weights in `layout`."""
    path.mkdir(parents=True, exist_ok=True)
    params = jax.tree_util.tree_map(np.asarray, _jax_params())
    if layout == "jax_safetensors":
        save_torch_state_dict(jexport(params, JaxModelConfig.tiny()),
                              str(path / "model.safetensors"))
    elif layout == "jax_bin":
        save_torch_state_dict(jexport(params, JaxModelConfig.tiny()),
                              str(path / "pytorch_model.bin"))
    else:  # the port's exporter, as two shards of the released layout
        sd = {k: torch.from_numpy(np.array(v)) for k, v in
              export_state_dict(params, TINY).items()}
        keys = sorted(sd)
        halves = (keys[:len(keys) // 2], keys[len(keys) // 2:])
        for i, part in enumerate(halves, 1):
            shard = {k: sd[k] for k in part}
            if layout == "port_bin_shards":
                torch.save(shard, path / f"pytorch_model-0000{i}-of-00002.bin")
            else:
                safetensors.save_file(shard, str(path / f"model-0000{i}-of-00002.safetensors"))
    return path


def _cfgs(path, **kw):
    return (PlanGenConfig(model=TINY, janus_path=str(path), **kw),
            JaxConfig(model=JaxModelConfig.tiny(), janus_path=str(path), **kw))


LAYOUTS = ["jax_safetensors", "jax_bin", "port_bin_shards", "port_safetensors_shards"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoint_loads_as_jax_loads_it(tmp_path, layout):
    path = _write_checkpoint(tmp_path / "janus", layout)
    cfg, jcfg = _cfgs(path)
    model = load_params(cfg, dtype=torch.float32)
    want = jexport(jax.tree_util.tree_map(np.asarray, jload_params(jcfg, dtype=jnp.float32)),
                   JaxModelConfig.tiny())
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # and so are its outputs: the image-token embeds through gen_aligner
    ids = np.array([[0, 5, 17, TINY.image_token_size - 1]])
    with torch.no_grad():
        out = model.gen_img_embeds(torch.from_numpy(ids)).numpy()
    jparams = jload_params(jcfg, dtype=jnp.float32)
    np.testing.assert_allclose(out, np.asarray(jvlm.gen_img_embeds(jparams, jnp.asarray(ids))),
                               rtol=1e-5, atol=1e-6)  # fp32 matmuls summed in another order


def test_bf16_checkpoint_loads_bitwise(tmp_path):
    sd = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16) for k, v in export_state_dict(
        jax.tree_util.tree_map(np.asarray, _jax_params()), TINY).items()}
    (tmp_path / "j").mkdir()
    safetensors.save_file(sd, str(tmp_path / "j" / "model.safetensors"))
    model = load_params(PlanGenConfig(model=TINY, janus_path=str(tmp_path / "j")))
    for k, v in model.state_dict().items():
        # bf16 but for what the model keeps in fp32 (the VQ codebook)
        assert torch.equal(v, sd[k].to(v.dtype)), k
    assert model.gen_embed.weight.dtype == torch.bfloat16


def test_extra_key_is_skipped_and_missing_key_raises(tmp_path, capsys):
    sd = read_checkpoint_dir(str(_write_checkpoint(tmp_path / "a", "jax_safetensors")))
    sd["vision_model.vision_tower.attn_pool.latent"] = torch.zeros(1, 1, 4)
    (tmp_path / "extra").mkdir()
    safetensors.save_file(sd, str(tmp_path / "extra" / "model.safetensors"))
    model = load_params(PlanGenConfig(model=TINY, janus_path=str(tmp_path / "extra")),
                        dtype=torch.float32)
    assert "attn_pool.latent" in capsys.readouterr().err
    assert "vision_model.vision_tower.attn_pool.latent" not in model.state_dict()

    del sd["gen_embed.weight"]
    (tmp_path / "missing").mkdir()
    safetensors.save_file(sd, str(tmp_path / "missing" / "model.safetensors"))
    with pytest.raises(KeyError, match="gen_embed.weight"):
        load_params(PlanGenConfig(model=TINY, janus_path=str(tmp_path / "missing")))


def test_finetune_overlay_as_jax(tmp_path, capsys):
    path = _write_checkpoint(tmp_path / "janus", "jax_bin")
    base = read_checkpoint_dir(str(path))
    overlay = {"vl_gpt.gen_embed.weight": base["gen_embed.weight"] * 2 + 1,
               "vl_gpt.aligner.layers.0.bias": base["aligner.layers.0.bias"] - 3,
               "vl_gpt.lora_A.not_in_the_base": torch.ones(2)}
    torch.save(overlay, tmp_path / "trainable_model_parameters.pth")
    cfg, jcfg = _cfgs(path, finetune_path=str(tmp_path / "trainable_model_parameters.pth"))
    model = load_params(cfg, dtype=torch.float32)
    assert "1 overlay keys match no base weight" in capsys.readouterr().err
    got = model.state_dict()
    torch.testing.assert_close(got["gen_embed.weight"], overlay["vl_gpt.gen_embed.weight"],
                               rtol=0, atol=0)
    want = jexport(jax.tree_util.tree_map(np.asarray, jload_params(jcfg, dtype=jnp.float32)),
                   JaxModelConfig.tiny())
    for k in ("gen_embed.weight", "aligner.layers.0.bias", "gen_head.vision_head.weight"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_no_weights_is_none_and_params_path_raises(tmp_path, capsys):
    assert load_params(PlanGenConfig(model=TINY)) is None
    assert "RANDOM init" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="orbax"):
        load_params(PlanGenConfig(model=TINY, params_path=str(tmp_path)))


def test_trainer_starts_from_loaded_janus_path(tmp_path):
    from plangen_tpu_torch.config import FlowConfig, apply_overrides
    from plangen_tpu_torch.train.trainer import Trainer

    path = _write_checkpoint(tmp_path / "janus", "port_bin_shards")
    cfg = apply_overrides(PlanGenConfig(model=TINY, janus_path=str(path), janus_hw=32), {
        "train.train_data": (FlowConfig("uni", "toy", 2),),
        "train.output_dir": str(tmp_path / "run"),
    })
    t = Trainer(cfg, device="cpu")
    want = load_params(cfg, dtype=torch.float32).state_dict()
    for k, v in t.model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), k


# ------------------------------------------------------------ safetensors


def _all_dtypes():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 3, generator=g).bfloat16(),
        "i64": torch.randint(-2**40, 2**40, (4,), generator=g),
        "i32": torch.randint(-2**30, 2**30, (3, 1), generator=g, dtype=torch.int32),
        "i8": torch.randint(-128, 128, (5,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (1, 9), generator=g, dtype=torch.uint8),
        "bool": torch.rand(6, generator=g) > 0.5,
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


def test_reader_reads_the_package_files(tmp_path):
    tensors = _all_dtypes()
    st_save(tensors, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = safetensors.load_file(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_writer_is_read_by_the_package(tmp_path):
    tensors = _all_dtypes()
    safetensors.save_file(tensors, str(tmp_path / "b.safetensors"), metadata={"k": "v"})
    got = st_load(str(tmp_path / "b.safetensors"))
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    back = safetensors.load_file(str(tmp_path / "b.safetensors"))
    for k, v in tensors.items():
        assert torch.equal(back[k], v), k


def test_reader_refuses_other_dtypes_and_broken_files(tmp_path):
    st_save({"f64": torch.zeros(2, dtype=torch.float64)}, str(tmp_path / "c.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        safetensors.load_file(str(tmp_path / "c.safetensors"))
    (tmp_path / "d.safetensors").write_bytes(b"\xff" * 16)
    with pytest.raises(ValueError, match="header length"):
        safetensors.load_file(str(tmp_path / "d.safetensors"))
