"""Weights as the HF-named state dict: the reference's torch format.

A copy of `export_state_dict`, `export_trainable_state_dict`,
`save_torch_state_dict` and the helpers they need from
`plangen_tpu/convert/jax_to_torch.py` (the port imports nothing of the JAX
package), over a JAX parameter tree of numpy arrays: linear [in, out] ->
[out, in], conv HWIO -> OIHW, the layer-stacked [L, ...] LM / SigLIP arrays
unstacked into per-layer keys, the HF `MultiModalityCausalLM` submodule
names. Quantized trees are refused; a tree with LoRA adapters is merged
first (`train/lora.py::merge_lora`, on the tree), as the original merges
it. One rule per tuning mode (`_TRAINED`, over HF keys) filters both
entry points as the JAX package's path predicates
(`plangen_tpu/train/optim.py::TUNING_MODES`) filter the tree.
tests/test_torch_copies.py and tests/test_torch_artifacts.py hold them key
for key and array for array against the originals.

`model_state_dict` gives the same dicts from the port's own
`PlanGenModel`, whose module names are the HF names: its state dict in
fp32 with LoRA merged (on a copy), a quantized model refused as
`_check_dense` refuses a quantized tree.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from plangen_tpu_torch.config import PlanGenModelConfig, ProjectorConfig
from plangen_tpu_torch.train.optim import TUNING_MODES as OPTIM_MODES


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
    """Collects hf_name -> array, refusing a name twice."""

    def __init__(self) -> None:
        self.sd: Dict[str, np.ndarray] = {}

    def put(self, hf_name: str, arr: Any) -> None:
        if hf_name in self.sd:
            raise ValueError(f"duplicate export key {hf_name}")
        self.sd[hf_name] = _np(arr)

    def linear(self, hf_name: str, w: Any) -> None:
        self.put(hf_name, _np(w).T)  # [in, out] -> [out, in]

    def conv(self, hf_name: str, w: Any) -> None:
        self.put(hf_name, _np(w).transpose(3, 2, 0, 1))  # HWIO -> OIHW


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
    em.put(m + "embed_tokens.weight", lm["embed_tokens"])
    em.put(m + "norm.weight", lm["final_norm"])
    em.linear(p + "lm_head.weight", lm["lm_head"])
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
            if is_linear:
                em.linear(name, stacked[i])
            else:
                em.put(name, stacked[i])


def _export_siglip(em: _Emitter, vm: Dict[str, Any], p: str) -> None:
    em.conv(p + "patch_embed.proj.weight", vm["patch_embed"]["w"])
    em.put(p + "patch_embed.proj.bias", vm["patch_embed"]["b"])
    em.put(p + "pos_embed", vm["pos_embed"])
    em.put(p + "norm.weight", vm["final_norm"]["scale"])
    em.put(p + "norm.bias", vm["final_norm"]["bias"])
    layers = vm["layers"]
    L = len(_np(layers["norm1"]["scale"]))
    for i in range(L):
        b = f"{p}blocks.{i}."
        for mod, hf_mod in (("norm1", "norm1"), ("norm2", "norm2")):
            em.put(b + hf_mod + ".weight", _np(layers[mod]["scale"])[i])
            em.put(b + hf_mod + ".bias", _np(layers[mod]["bias"])[i])
        for mod, hf_mod in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                            ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            em.linear(b + hf_mod + ".weight", _np(layers[mod]["w"])[i])
            em.put(b + hf_mod + ".bias", _np(layers[mod]["b"])[i])


def _export_projector(
    em: _Emitter, proj: Dict[str, Any], pcfg: ProjectorConfig, p: str
) -> None:
    layers: List[Dict[str, Any]] = proj["layers"]
    if pcfg.projector_type == "identity" or not layers:
        return
    if pcfg.projector_type == "linear":
        em.linear(p + "layers.weight", layers[0]["w"])
        em.put(p + "layers.bias", layers[0]["b"])
        return
    # mlp_gelu Sequential: Linear at indices 0, 2, 4, ... (GELU between)
    for j, lyr in enumerate(layers):
        em.linear(f"{p}layers.{2 * j}.weight", lyr["w"])
        em.put(f"{p}layers.{2 * j}.bias", lyr["b"])


def _export_gn(em: _Emitter, node, hf: str) -> None:
    em.put(hf + ".weight", node["scale"])
    em.put(hf + ".bias", node["bias"])


def _export_conv(em: _Emitter, node, hf: str) -> None:
    em.conv(hf + ".weight", node["w"])
    em.put(hf + ".bias", node["b"])


def _export_resblock(em: _Emitter, node, hf: str) -> None:
    _export_gn(em, node["norm1"], hf + "norm1")
    _export_conv(em, node["conv1"], hf + "conv1")
    _export_gn(em, node["norm2"], hf + "norm2")
    _export_conv(em, node["conv2"], hf + "conv2")
    if "nin_shortcut" in node:
        _export_conv(em, node["nin_shortcut"], hf + "nin_shortcut")


def _export_attnblock(em: _Emitter, node, hf: str) -> None:
    _export_gn(em, node["norm"], hf + "norm")
    for k in ("q", "k", "v", "proj_out"):
        _export_conv(em, node[k], hf + k)


def _export_vq(em: _Emitter, vq: Dict[str, Any], p: str) -> None:
    def side(tower: Dict[str, Any], prefix: str) -> None:
        _export_conv(em, tower["conv_in"], prefix + "conv_in")
        for li, level in enumerate(tower["levels"]):
            lp = f"{prefix}conv_blocks.{li}."
            for r, res in enumerate(level["res"]):
                _export_resblock(em, res, f"{lp}res.{r}.")
            for r, attn in enumerate(level["attn"]):
                _export_attnblock(em, attn, f"{lp}attn.{r}.")
            if "down" in level:
                _export_conv(em, level["down"]["conv"], lp + "downsample.conv")
            if "up" in level:
                _export_conv(em, level["up"]["conv"], lp + "upsample.conv")
        for idx, key in ((0, "res1"), (1, "attn"), (2, "res2")):
            fn = _export_attnblock if key == "attn" else _export_resblock
            fn(em, tower["mid"][key], f"{prefix}mid.{idx}.")
        _export_gn(em, tower["norm_out"], prefix + "norm_out")
        _export_conv(em, tower["conv_out"], prefix + "conv_out")

    side(vq["encoder"], p + "encoder.")
    side(vq["decoder"], p + "decoder.")
    em.put(p + "quantize.embedding.weight", vq["codebook"])
    _export_conv(em, vq["quant_conv"], p + "quant_conv")
    _export_conv(em, vq["post_quant_conv"], p + "post_quant_conv")


def _export(params: Dict[str, Any], cfg: PlanGenModelConfig) -> Dict[str, np.ndarray]:
    params = _check_dense(params)
    em = _Emitter()
    _export_lm(em, params["language_model"], "language_model.")
    _export_siglip(em, params["vision_model"], "vision_model.vision_tower.")
    _export_projector(em, params["aligner"], cfg.aligner, "aligner.")
    _export_projector(em, params["gen_aligner"], cfg.gen_aligner, "gen_aligner.")
    em.linear("gen_head.output_mlp_projector.weight", params["gen_head"]["fc1"]["w"])
    em.put("gen_head.output_mlp_projector.bias", params["gen_head"]["fc1"]["b"])
    em.linear("gen_head.vision_head.weight", params["gen_head"]["fc2"]["w"])
    em.put("gen_head.vision_head.bias", params["gen_head"]["fc2"]["b"])
    em.put("gen_embed.weight", params["gen_embed"])
    _export_vq(em, params["gen_vision_model"], "gen_vision_model.")
    return em.sd


def export_state_dict(
    params: Dict[str, Any], cfg: PlanGenModelConfig
) -> Dict[str, np.ndarray]:
    """Full HF-named state dict (numpy values) from a dense param pytree."""
    return _export(params, cfg)


_LM_ATTN_PROJ = re.compile(
    r"^language_model\.model\.layers\.\d+\.self_attn\.[qkvo]_proj\.weight$")

# what each tuning mode trained, over HF keys: the optimizer's rules
# (train/optim.py, the JAX package's TUNING_MODES), except that the LoRA
# modes keep the merged projections the adapters touched in place of the
# adapters, 'lora_tokens' the token embedding too
_TRAINED: Dict[str, Callable[[str], bool]] = {
    **OPTIM_MODES,
    "lora": lambda k: bool(_LM_ATTN_PROJ.match(k)),
    "lora_tokens": lambda k: (bool(_LM_ATTN_PROJ.match(k))
                              or OPTIM_MODES["lora_tokens"](k)),
}
TUNING_MODES = tuple(_TRAINED)


def _trained(tuning_mode: str) -> Callable[[str], bool]:
    if tuning_mode not in _TRAINED:
        raise ValueError(
            f"unknown tuning_mode {tuning_mode!r}; "
            f"options: {sorted(TUNING_MODES)}"
        )
    return _TRAINED[tuning_mode]


def export_trainable_state_dict(
    params: Dict[str, Any], cfg: PlanGenModelConfig, tuning_mode: str,
    prefix: str = "vl_gpt.",
) -> Dict[str, np.ndarray]:
    """Only the keys a tuning mode trained — the reference's
    `trainable_model_parameters.pth` payload (base_system.py:166-189),
    filtered by the rules the JAX optimizer froze with (`_TRAINED`).

    Keys carry the `vl_gpt.` prefix by default: the reference saves from
    the SYSTEM module's `named_parameters()` (base_system.py:188-189)
    where the VLM is registered as `self.vl_gpt` (plangen_base.py:104),
    and loads the payload back with `self.load_state_dict(sd,
    strict=False)` (base_system.py:153-154) — bare HF names would
    silently match ZERO keys there. Pass `prefix=""` for bare HF names
    (e.g. to overlay onto an HF `MultiModalityCausalLM` directly).

    'lora'/'lora_tokens' export the MERGED projections the adapters touched
    (q/k/v/o — the reference can only consume merged weights), plus the
    token embedding for 'lora_tokens'.
    """
    keep = _trained(tuning_mode)
    return {prefix + k: v for k, v in _export(params, cfg).items() if keep(k)}


def model_state_dict(model, tuning_mode: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The HF-named state dict of a port `PlanGenModel` as numpy fp32:
    `export_state_dict`'s dict (bare names) without `tuning_mode`, else
    `export_trainable_state_dict`'s (`vl_gpt.` names). LoRA adapters are
    merged on a copy; a quantized model raises ValueError."""
    import torch

    from plangen_tpu_torch.ops.quant import quant_form
    from plangen_tpu_torch.train.lora import has_lora, merge_lora

    form = quant_form(model)
    if form is not None:
        raise ValueError(
            f"cannot export a quantized model ({form}): quantization is "
            "lossy — export from the dense artifact (load with "
            "generation.quantize unset, or `cli convert` WITHOUT --quantize)"
        )
    keep = (lambda k: True) if tuning_mode is None else _trained(tuning_mode)
    if has_lora(model):
        model = merge_lora(copy.deepcopy(model))
    prefix = "" if tuning_mode is None else "vl_gpt."
    return {prefix + k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in model.state_dict().items() if keep(k)}


def save_torch_state_dict(sd: Dict[str, np.ndarray], path: str) -> str:
    """Write the exported dict: .pth via torch (the reference's format),
    .safetensors via the port's writer (`convert/safetensors.py`), .npz as
    the no-deps fallback."""
    if path.endswith((".pth", ".pt", ".bin")):
        import torch

        # copy: read-only numpy views make torch.from_numpy warn
        torch.save({k: torch.from_numpy(np.array(v, copy=True))
                    for k, v in sd.items()}, path)
    elif path.endswith(".safetensors"):
        import torch

        from plangen_tpu_torch.convert.safetensors import save_file

        save_file({k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in sd.items()}, path)
    elif path.endswith(".npz"):
        np.savez(path, **sd)
    else:
        raise ValueError(
            f"unsupported export extension on {path!r}: "
            "use .pth/.pt/.bin (torch), .safetensors, or .npz"
        )
    return path
