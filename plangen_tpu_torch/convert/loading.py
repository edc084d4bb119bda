"""Model weights for the pipeline and the trainer, from local files.

Port of `plangen_tpu/convert/loading.py::load_params` and of the checkpoint
reading of `plangen_tpu/convert/torch_to_jax.py::load_janus_checkpoint`.
Weights resolve in this order:

  1. `cfg.params_path`, the port's weight artifact (`convert/params.py`:
     a safetensors state dict and a JSON naming its quantized form, written
     by `cli convert` or `PlanGenCheckpointer.save_params_only`); a
     quantized one is loaded in its form, the scales fp32. A directory
     without the JSON (an orbax artifact of the JAX package, which needs
     orbax and jax) raises `NotImplementedError`;
  2. `cfg.janus_path`, a local HF checkout: its `*.safetensors` files
     (read by `convert/safetensors.py`), or else its `pytorch_model*.bin`
     shards (`torch.load(..., weights_only=True)`), then the
     `cfg.finetune_path` overlay, a partial state dict whose `vl_gpt.` key
     prefix is stripped and whose keys that match no base weight are
     reported and skipped;
  3. neither: None, with a warning on stderr, and the caller fills the
     model with seeded random weights.

The port's module names are the HF names, so a checkpoint's keys are the
model's state-dict keys. Loading raises on any key the model needs that the
checkpoint lacks; a key the model does not take is skipped and listed on
stderr, as the JAX converter reads only the keys it needs.

`load_tokenizer_for` gives the entry points the checkout's tokenizer, or
the byte fallback when the checkout holds weights alone.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, Optional

import torch
from torch import nn

from plangen_tpu_torch.config import PlanGenConfig
from plangen_tpu_torch.convert import safetensors
from plangen_tpu_torch.text.tokenizer import load_tokenizer


def has_weight_files(path: Optional[str]) -> bool:
    if not path or not os.path.isdir(path):
        return False
    return any(n.endswith(".safetensors") or n.startswith("pytorch_model")
               for n in os.listdir(path))


def read_checkpoint_dir(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of an HF checkpoint directory, on the CPU: every
    `*.safetensors` file, or else every `pytorch_model*.bin` shard."""
    files = sorted(os.listdir(path))
    st_files = [f for f in files if f.endswith(".safetensors")]
    bin_files = [f for f in files if re.match(r"pytorch_model.*\.bin$", f)]
    sd: Dict[str, torch.Tensor] = {}
    if st_files:
        for f in st_files:
            sd.update(safetensors.load_file(os.path.join(path, f)))
    elif bin_files:
        for f in bin_files:
            sd.update(torch.load(os.path.join(path, f), map_location="cpu",
                                 weights_only=True))
    else:
        raise FileNotFoundError(f"no model weights found in {path}")
    return sd


def overlay_finetune(sd: Dict[str, torch.Tensor], finetune_path: str) -> Dict[str, torch.Tensor]:
    """`sd` with the entries of a PlanGen fine-tune payload over it.

    The payload is saved from the training system's parameters, where the
    VLM is `vl_gpt`, so its keys carry a `vl_gpt.` prefix the base state
    dict lacks; it is stripped. Keys that then match no base weight are
    reported and skipped (strict=False semantics)."""
    overlay = torch.load(finetune_path, map_location="cpu", weights_only=True)
    overlay = {(k[len("vl_gpt."):] if k.startswith("vl_gpt.") else k): v
               for k, v in overlay.items()}
    unmatched = sorted(k for k in overlay if k not in sd)
    if unmatched:
        sys.stderr.write(f"load_params: {len(unmatched)} overlay keys match no base "
                         f"weight (first: {unmatched[0]}); skipped, per strict=False "
                         "semantics\n")
    return {**sd, **{k: v for k, v in overlay.items() if k in sd}}


@torch.no_grad()
def load_state_dict_checked(model: nn.Module, sd: Dict[str, torch.Tensor]) -> List[str]:
    """Copy `sd` into `model` (cast to each tensor's dtype, moved to its
    device); returns the skipped keys. Raises `KeyError` naming the model's
    keys the state dict lacks; lists on stderr the keys the model does not
    take, and skips them."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} weights the model needs "
                       f"(first: {missing[:3]})")
    skipped = sorted(k for k in sd if k not in own)
    if skipped:
        sys.stderr.write(f"load_params: skipped {len(skipped)} checkpoint keys the "
                         f"model does not take: {skipped[:8]}"
                         + (" ..." if len(skipped) > 8 else "") + "\n")
    for name, tensor in own.items():
        src = sd[name]
        if tuple(src.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)}, "
                             f"model shape {tuple(tensor.shape)}")
        tensor.copy_(src)
    return skipped


def load_tokenizer_for(cfg: PlanGenConfig):
    """The tokenizer of `cfg.janus_path` when it holds one (`tokenizer.json`
    or `tokenizer_config.json`), else the byte fallback; a checkout of
    weights alone gets the fallback with a warning on stderr."""
    path = cfg.janus_path
    has_tokenizer = bool(path) and any(
        os.path.exists(os.path.join(path, n))
        for n in ("tokenizer.json", "tokenizer_config.json"))
    if path and not has_tokenizer:
        print(f"plangen_tpu_torch: no tokenizer files in janus_path={path!r} - using "
              "the byte-fallback tokenizer", file=sys.stderr)
    return load_tokenizer(
        path if has_tokenizer else None,
        vocab_size=cfg.model.llama.vocab_size,
        use_special_tokens=cfg.use_special_tokens,
        use_numhw=cfg.use_numhw_tokens,
    )


def load_params(cfg: PlanGenConfig, model: Optional[nn.Module] = None, device=None,
                dtype: torch.dtype = torch.bfloat16) -> Optional[nn.Module]:
    """The model with the weights `cfg` names (module docstring), or None
    when it names none. `model` is filled in place when given, else a
    `PlanGenModel` of `cfg.model` is built in `dtype` on `device`."""
    if cfg.params_path:
        from plangen_tpu_torch.convert.params import load_params_artifact

        return load_params_artifact(cfg.params_path, cfg.model, model, device, dtype)
    if not has_weight_files(cfg.janus_path):
        print("plangen_tpu_torch: no weights found (params_path/janus_path unset or "
              "weightless) - using RANDOM init", file=sys.stderr)
        return None
    sd = read_checkpoint_dir(cfg.janus_path)
    if cfg.finetune_path:
        sd = overlay_finetune(sd, cfg.finetune_path)
    if model is None:
        from plangen_tpu_torch.models.vlm import PlanGenModel

        model = PlanGenModel(cfg.model, dtype=dtype, device=device)
    load_state_dict_checked(model, sd)
    return model
