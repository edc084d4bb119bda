"""The JAX parameter tree as the HF-named state dict (numpy only).

A copy of `export_state_dict` and the helpers it needs from
`plangen_tpu/convert/jax_to_torch.py` (the port imports nothing of the JAX
package): linear [in, out] -> [out, in], conv HWIO -> OIHW, the
layer-stacked [L, ...] LM / SigLIP arrays unstacked into per-layer keys, the
HF `MultiModalityCausalLM` submodule names. Quantized trees are refused; a
tree with LoRA adapters is merged first (`train/lora.py::merge_lora`, on the
tree), as the original merges it. tests/test_torch_copies.py holds it key
for key and array for array against the original.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from plangen_tpu_torch.config import PlanGenModelConfig, ProjectorConfig


def _np(x: Any) -> np.ndarray:
    arr = np.asarray(x)
    if arr.dtype == np.dtype("V2"):
        # raw 2-byte void = bf16 that lost its ml_dtypes registration:
        # reinterpret the bits first (astype on a void dtype raises)
        import ml_dtypes

        arr = arr.view(ml_dtypes.bfloat16).astype(np.float32)
    elif "bfloat16" in str(arr.dtype):
        # ml_dtypes bf16 torch.save's fine via numpy only as fp32
        arr = arr.astype(np.float32)
    return arr


class _Emitter:
    """Collects (hf_name -> array) plus the pytree path each came from, so
    tuning-mode filters run on the SAME "a/b/c" strings train/optim used."""

    def __init__(self) -> None:
        self.sd: Dict[str, np.ndarray] = {}
        self.jax_path: Dict[str, str] = {}

    def put(self, hf_name: str, arr: Any, path: str) -> None:
        if hf_name in self.sd:
            raise ValueError(f"duplicate export key {hf_name}")
        self.sd[hf_name] = _np(arr)
        self.jax_path[hf_name] = path

    def linear(self, hf_name: str, w: Any, path: str) -> None:
        self.put(hf_name, _np(w).T, path)  # [in, out] -> [out, in]

    def conv(self, hf_name: str, w: Any, path: str) -> None:
        self.put(hf_name, _np(w).transpose(3, 2, 0, 1), path)  # HWIO -> OIHW


def _check_dense(params: Dict[str, Any]) -> Dict[str, Any]:
    """Refuse quantized trees; merge LoRA adapters into the base weights."""

    def find_quant(node, path=""):
        if isinstance(node, dict):
            if "w_q8" in node or "w_p4" in node:
                return path
            for k, v in node.items():
                hit = find_quant(v, f"{path}/{k}" if path else k)
                if hit:
                    return hit
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                hit = find_quant(v, f"{path}/{i}")
                if hit:
                    return hit
        return None

    hit = find_quant(params)
    if hit:
        raise ValueError(
            f"cannot export a quantized tree (found {hit}): quantization is "
            "lossy — export from the dense artifact (load with "
            "generation.quantize unset, or `cli convert` WITHOUT --quantize)"
        )
    if "lora" in params.get("language_model", {}):
        # the reference has no adapter concept: export the merged projections
        from plangen_tpu_torch.train.lora import merge_lora

        params = merge_lora(params)
    return params


def _export_lm(em: _Emitter, lm: Dict[str, Any], p: str) -> None:
    m = p + "model."
    em.put(m + "embed_tokens.weight", lm["embed_tokens"],
           "language_model/embed_tokens")
    em.put(m + "norm.weight", lm["final_norm"], "language_model/final_norm")
    em.linear(p + "lm_head.weight", lm["lm_head"], "language_model/lm_head")
    layers = lm["layers"]
    hf = {
        "input_norm": ("input_layernorm.weight", False),
        "post_attn_norm": ("post_attention_layernorm.weight", False),
        "q_proj": ("self_attn.q_proj.weight", True),
        "k_proj": ("self_attn.k_proj.weight", True),
        "v_proj": ("self_attn.v_proj.weight", True),
        "o_proj": ("self_attn.o_proj.weight", True),
        "gate_proj": ("mlp.gate_proj.weight", True),
        "up_proj": ("mlp.up_proj.weight", True),
        "down_proj": ("mlp.down_proj.weight", True),
    }
    L = len(_np(layers["input_norm"]))
    for key, (suffix, is_linear) in hf.items():
        stacked = _np(layers[key])
        for i in range(L):
            name = f"{m}layers.{i}.{suffix}"
            path = f"language_model/layers/{key}"
            if is_linear:
                em.linear(name, stacked[i], path)
            else:
                em.put(name, stacked[i], path)


def _export_siglip(em: _Emitter, vm: Dict[str, Any], p: str) -> None:
    em.conv(p + "patch_embed.proj.weight", vm["patch_embed"]["w"],
            "vision_model/patch_embed/w")
    em.put(p + "patch_embed.proj.bias", vm["patch_embed"]["b"],
           "vision_model/patch_embed/b")
    em.put(p + "pos_embed", vm["pos_embed"], "vision_model/pos_embed")
    em.put(p + "norm.weight", vm["final_norm"]["scale"],
           "vision_model/final_norm/scale")
    em.put(p + "norm.bias", vm["final_norm"]["bias"],
           "vision_model/final_norm/bias")
    layers = vm["layers"]
    L = len(_np(layers["norm1"]["scale"]))
    for i in range(L):
        b = f"{p}blocks.{i}."
        for mod, hf_mod in (("norm1", "norm1"), ("norm2", "norm2")):
            em.put(b + hf_mod + ".weight", _np(layers[mod]["scale"])[i],
                   f"vision_model/layers/{mod}/scale")
            em.put(b + hf_mod + ".bias", _np(layers[mod]["bias"])[i],
                   f"vision_model/layers/{mod}/bias")
        for mod, hf_mod in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                            ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            em.linear(b + hf_mod + ".weight", _np(layers[mod]["w"])[i],
                      f"vision_model/layers/{mod}/w")
            em.put(b + hf_mod + ".bias", _np(layers[mod]["b"])[i],
                   f"vision_model/layers/{mod}/b")


def _export_projector(
    em: _Emitter, proj: Dict[str, Any], pcfg: ProjectorConfig, p: str,
    path: str,
) -> None:
    layers: List[Dict[str, Any]] = proj["layers"]
    if pcfg.projector_type == "identity" or not layers:
        return
    if pcfg.projector_type == "linear":
        em.linear(p + "layers.weight", layers[0]["w"], f"{path}/layers/0/w")
        em.put(p + "layers.bias", layers[0]["b"], f"{path}/layers/0/b")
        return
    # mlp_gelu Sequential: Linear at indices 0, 2, 4, ... (GELU between)
    for j, lyr in enumerate(layers):
        em.linear(f"{p}layers.{2 * j}.weight", lyr["w"],
                  f"{path}/layers/{j}/w")
        em.put(f"{p}layers.{2 * j}.bias", lyr["b"], f"{path}/layers/{j}/b")


def _export_gn(em: _Emitter, node, hf: str, path: str) -> None:
    em.put(hf + ".weight", node["scale"], path + "/scale")
    em.put(hf + ".bias", node["bias"], path + "/bias")


def _export_conv(em: _Emitter, node, hf: str, path: str) -> None:
    em.conv(hf + ".weight", node["w"], path + "/w")
    em.put(hf + ".bias", node["b"], path + "/b")


def _export_resblock(em: _Emitter, node, hf: str, path: str) -> None:
    _export_gn(em, node["norm1"], hf + "norm1", path + "/norm1")
    _export_conv(em, node["conv1"], hf + "conv1", path + "/conv1")
    _export_gn(em, node["norm2"], hf + "norm2", path + "/norm2")
    _export_conv(em, node["conv2"], hf + "conv2", path + "/conv2")
    if "nin_shortcut" in node:
        _export_conv(em, node["nin_shortcut"], hf + "nin_shortcut",
                     path + "/nin_shortcut")


def _export_attnblock(em: _Emitter, node, hf: str, path: str) -> None:
    _export_gn(em, node["norm"], hf + "norm", path + "/norm")
    for k in ("q", "k", "v", "proj_out"):
        _export_conv(em, node[k], hf + k, path + "/" + k)


def _export_vq(em: _Emitter, vq: Dict[str, Any], p: str) -> None:
    def side(tower: Dict[str, Any], prefix: str, path: str) -> None:
        _export_conv(em, tower["conv_in"], prefix + "conv_in",
                     path + "/conv_in")
        for li, level in enumerate(tower["levels"]):
            lp = f"{prefix}conv_blocks.{li}."
            lpath = f"{path}/levels/{li}"
            for r, res in enumerate(level["res"]):
                _export_resblock(em, res, f"{lp}res.{r}.",
                                 f"{lpath}/res/{r}")
            for r, attn in enumerate(level["attn"]):
                _export_attnblock(em, attn, f"{lp}attn.{r}.",
                                  f"{lpath}/attn/{r}")
            if "down" in level:
                _export_conv(em, level["down"]["conv"],
                             lp + "downsample.conv", lpath + "/down/conv")
            if "up" in level:
                _export_conv(em, level["up"]["conv"],
                             lp + "upsample.conv", lpath + "/up/conv")
        for idx, key in ((0, "res1"), (1, "attn"), (2, "res2")):
            fn = _export_attnblock if key == "attn" else _export_resblock
            fn(em, tower["mid"][key], f"{prefix}mid.{idx}.",
               f"{path}/mid/{key}")
        _export_gn(em, tower["norm_out"], prefix + "norm_out",
                   path + "/norm_out")
        _export_conv(em, tower["conv_out"], prefix + "conv_out",
                     path + "/conv_out")

    side(vq["encoder"], p + "encoder.", "gen_vision_model/encoder")
    side(vq["decoder"], p + "decoder.", "gen_vision_model/decoder")
    em.put(p + "quantize.embedding.weight", vq["codebook"],
           "gen_vision_model/codebook")
    _export_conv(em, vq["quant_conv"], p + "quant_conv",
                 "gen_vision_model/quant_conv")
    _export_conv(em, vq["post_quant_conv"], p + "post_quant_conv",
                 "gen_vision_model/post_quant_conv")


def _export(params: Dict[str, Any], cfg: PlanGenModelConfig) -> _Emitter:
    params = _check_dense(params)
    em = _Emitter()
    _export_lm(em, params["language_model"], "language_model.")
    _export_siglip(em, params["vision_model"],
                   "vision_model.vision_tower.")
    _export_projector(em, params["aligner"], cfg.aligner, "aligner.",
                      "aligner")
    _export_projector(em, params["gen_aligner"], cfg.gen_aligner,
                      "gen_aligner.", "gen_aligner")
    em.linear("gen_head.output_mlp_projector.weight",
              params["gen_head"]["fc1"]["w"], "gen_head/fc1/w")
    em.put("gen_head.output_mlp_projector.bias",
           params["gen_head"]["fc1"]["b"], "gen_head/fc1/b")
    em.linear("gen_head.vision_head.weight", params["gen_head"]["fc2"]["w"],
              "gen_head/fc2/w")
    em.put("gen_head.vision_head.bias", params["gen_head"]["fc2"]["b"],
           "gen_head/fc2/b")
    em.put("gen_embed.weight", params["gen_embed"], "gen_embed")
    _export_vq(em, params["gen_vision_model"], "gen_vision_model.")
    return em


def export_state_dict(
    params: Dict[str, Any], cfg: PlanGenModelConfig
) -> Dict[str, np.ndarray]:
    """Full HF-named state dict (numpy values) from a dense param pytree."""
    return _export(params, cfg).sd

