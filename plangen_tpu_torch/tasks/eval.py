"""Building the serving pipeline from a configuration.

Port of `build_pipeline` and its helpers in `plangen_tpu/tasks/eval.py`
(the evaluation harness `run_validation` is not ported yet): the
tokenizer and processor from `cfg`, the weights through
`convert/loading.py::load_params` (seeded random init when `cfg` names
none), then the serving form of `cfg.generation.quantize`.

The device is the card unless the caller names another: `build_pipeline
(cfg)` raises when there is no card, and `device="cpu"` builds on the CPU.

The JAX helpers `_artifact_quant_form`, `_apply_quantize` and
`_build_auto_int4` have their counterparts in `PlanGenPipeline.__init__`
and `ops/quant.py` (`quant_form`, `quantize_model_`, `int4_view`): a model
that is already quantized engages its own form (and the int8 cache) when
`quantize` is unset; another mode raises, `auto` included, since the int4
view of `auto` is built from the dense model. The JAX
package refuses `auto` above 6e9 bytes of dense LM weights, a rule for a
16 GB chip; on the 80 GB card the dense 7B LM (14.5 GB of bf16) and its
int4 copy fit, so the port keeps no such limit.
"""

from __future__ import annotations

from typing import Optional

import torch

from plangen_tpu_torch.config import PlanGenConfig, validate_config
from plangen_tpu_torch.convert.from_jax import init_params
from plangen_tpu_torch.convert.loading import load_params, load_tokenizer_for
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.tasks.pipeline import PlanGenPipeline
from plangen_tpu_torch.tasks.processor import PlanGenProcessor


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None; raises without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "plangen_tpu_torch serves on the card by default and "
                "torch.cuda.is_available() is False: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def build_pipeline(cfg: PlanGenConfig, model: Optional[PlanGenModel] = None,
                   device=None) -> PlanGenPipeline:
    """The pipeline `cfg` describes, on `device` (the card by default):
    `model` when given (moved there), else the weights `cfg` names, else
    seeded random weights (`cfg.generation.seed`), in `cfg.param_dtype`."""
    validate_config(cfg)
    device = resolve_device(device)
    proc = PlanGenProcessor(
        load_tokenizer_for(cfg),
        image_tokens=cfg.model.image_seq_len,
        max_seq_len=cfg.train.max_seq_len,
        gen=cfg.generation,
    )
    dtype = getattr(torch, cfg.param_dtype)
    if model is None:
        model = load_params(cfg, device=device, dtype=dtype)
    if model is None:
        model = PlanGenModel(cfg.model, dtype=dtype, device=device)
        init_params(model, torch.Generator(device=device).manual_seed(cfg.generation.seed))
    # the serving form of generation.quantize: PlanGenPipeline engages a
    # quantized model's own form, builds the int4 view of 'auto', quantizes
    # a dense model in place, and raises on a mismatch
    return PlanGenPipeline(model.to(device).eval(), cfg.model, proc, gen_cfg=cfg.generation)
