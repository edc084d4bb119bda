"""The port's weight artifact: its counterpart of the JAX package's orbax
`params_path`.

A directory of two files:

  * `model.safetensors`: the model's state dict through
    `convert/safetensors.py`, under the port's module names (the HF names).
    A quantized model's `Int8Linear` / `Int4Linear` buffers are stored as
    they are: int8 weights, fp32 scales;
  * `plangen_params.json`: `{"format": "plangen_tpu_torch.params",
    "version": 1, "quantize": null | "int8" | "int4" | "int4_a8"}`.

`save_params` writes one (`cli convert`, `PlanGenCheckpointer.
save_params_only`) and, as orbax refuses an existing destination, replaces
only an empty directory or an artifact (these two files and nothing else);
`load_params_artifact` fills a `PlanGenModel` from one:
a quantized artifact into `ops/quant.py::quantized_structure_` of its form,
the scales kept fp32 and every other floating tensor cast to the model's
dtype, as `plangen_tpu/convert/loading.py` casts an orbax tree; LoRA
adapters in the artifact are added to the model (`train/lora.py`) and
loaded unmerged. A directory without the JSON is not this format: an orbax
artifact of the JAX package needs orbax and jax, and `read_meta` raises
`NotImplementedError` saying so.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional

import torch
from torch import nn

from plangen_tpu_torch.config import PlanGenModelConfig
from plangen_tpu_torch.convert import safetensors

FORMAT = "plangen_tpu_torch.params"
VERSION = 1
META = "plangen_params.json"
WEIGHTS = "model.safetensors"
_SCALING = "language_model.model.lora_scaling"


def check_destination(path: str) -> None:
    """Raise `FileExistsError` unless `path` is free, an empty directory or
    an artifact directory holding only this format's two files: anything
    else there (a checkout, a home directory) is never replaced."""
    if not os.path.lexists(path):
        return
    if os.path.isdir(path) and not os.path.islink(path):
        entries = set(os.listdir(path))
        if not entries or (entries <= {META, WEIGHTS} and _is_artifact(path)):
            return
    raise FileExistsError(f"{path!r} exists and is not an artifact of this format: "
                          "give --out a new directory")


def _is_artifact(path: str) -> bool:
    try:
        read_meta(path)
    except (NotImplementedError, ValueError, OSError):
        return False
    return True


def save_params(model: nn.Module, path: str, mask: Optional[Dict[str, bool]] = None) -> str:
    """Write `model` as an artifact directory at `path` (see
    `check_destination` for what may be there already); with `mask`
    ({parameter name: keep}) only the kept parameters, which
    `load_params_artifact` then refuses as incomplete. Returns the absolute
    path."""
    from plangen_tpu_torch.ops.quant import quant_form

    path = os.path.abspath(path)
    check_destination(path)
    sd = model.state_dict()
    if mask is not None:
        sd = {k: v for k, v in sd.items() if mask.get(k, False)}
    meta = {"format": FORMAT, "version": VERSION, "quantize": quant_form(model)}
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".", dir=parent)
    os.chmod(tmp, 0o755)  # mkdtemp's 0o700 is for the name, not the artifact
    try:
        safetensors.save_file(sd, os.path.join(tmp, WEIGHTS), metadata={"format": FORMAT})
        with open(os.path.join(tmp, META), "w") as f:
            json.dump(meta, f)
        if os.path.lexists(path):
            shutil.rmtree(path)  # an empty directory or an artifact: checked above
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def read_meta(path: str) -> dict:
    """The artifact's JSON; raises `NotImplementedError` for a directory
    that is not this format (an orbax artifact of the JAX package) and
    `ValueError` for another format or version."""
    meta_path = os.path.join(path, META)
    if not os.path.isfile(meta_path):
        raise NotImplementedError(
            f"params_path={path!r} has no {META}: an orbax artifact of the JAX package "
            "needs orbax and jax, which the port does not use. Convert the HF checkout "
            "with `python -m plangen_tpu_torch.cli convert`, or point janus_path at it")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT or meta.get("version") != VERSION:
        raise ValueError(f"{meta_path}: format {meta.get('format')!r} version "
                         f"{meta.get('version')!r}, expected {FORMAT!r} {VERSION}")
    return meta


def load_params_artifact(path: str, model_cfg: PlanGenModelConfig,
                         model: Optional[nn.Module] = None, device=None,
                         dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The model with the artifact's weights: `model` filled in place
    (given the artifact's quantized form if it is dense), else a
    `PlanGenModel` of `model_cfg` in `dtype` on `device`."""
    from plangen_tpu_torch.convert.loading import load_state_dict_checked
    from plangen_tpu_torch.ops.quant import quant_form, quantized_structure_
    from plangen_tpu_torch.train.lora import add_lora, has_lora

    meta = read_meta(path)
    sd = safetensors.load_file(os.path.join(path, WEIGHTS))
    if model is None:
        from plangen_tpu_torch.models.vlm import PlanGenModel

        model = PlanGenModel(model_cfg, dtype=dtype, device=device)
    form = meta["quantize"]
    if form is not None and quant_form(model) is None:
        quantized_structure_(model, form)
    if quant_form(model) != form:
        raise ValueError(f"{path}: a {form or 'dense'} artifact for a "
                         f"{quant_form(model)}-quantized model")
    if _SCALING in sd and not has_lora(model):
        scaling = float(sd[_SCALING])
        rank = sd["language_model.model.layers.0.self_attn.lora.q_proj.a"].shape[1]
        add_lora(model, rank, scaling * rank)
    load_state_dict_checked(model, sd)
    return model
