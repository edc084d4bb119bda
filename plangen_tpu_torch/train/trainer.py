"""The training loop: the JAX package's `Trainer` on one device.

The device is the card (`cuda`) unless the caller names another:
`Trainer(cfg, device="cpu")` trains on the CPU, and `Trainer(cfg)` raises
when there is no card.

Port of `plangen_tpu/train/trainer.py`: build the tokenizer, processor,
model (the masters, in `train.master_dtype`), the LoRA adapters in the
'lora' mode, and the optimizer; iterate the flows' data; run the multi-task
step; log JSONL metrics; check the loss for non-finite values at the logging
cadence (save and raise); save every `checkpointing_steps` with FIFO
rotation; resume from the latest checkpoint; save at the end. Steps count
calls of the step, micro-steps under gradient accumulation, as in JAX.

Without `model=`, the weights come from a dense `cfg.params_path`
artifact (`convert/params.py`; a quantized one raises), or from
`cfg.janus_path` (and the `cfg.finetune_path` overlay), through
`convert/loading.py::load_params`, or are seeded random when it names none; either way the model is built in the
master dtype (a random tensor is drawn in fp32 and cast, as a cast of the
fp32 draw would give). A given model is cast to it.

`tuning_mode="lora"` adds adapters of `lora_rank` / `lora_alpha`
(`train/lora.py`, drawn from `seed + 1`) and trains them, and the token
embeddings too (`lora_tokens`) when `tune_token_when_lora` and special or
numhw tokens are on; the effective mode is printed.

`fit(validate_fn=...)` calls `validate_fn(step, model)` every
`train.validation_steps` steps, as the JAX loop calls it with the params;
`validate` runs `tasks/eval.py::run_validation` on `train.test_data` for
`train.val_max_len` batches on the trainer's own model (no reload), its
metrics logged under `val/` keys.

Not ported, and raising `NotImplementedError`: FSDP, a mesh of more than
one device, and weights from an orbax `params_path` of the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from plangen_tpu_torch.config import PlanGenConfig, validate_config
from plangen_tpu_torch.convert.from_jax import init_params
from plangen_tpu_torch.convert.loading import load_params, load_tokenizer_for
from plangen_tpu_torch.data.collate import collate_flows
from plangen_tpu_torch.data.loader import BatchLoader, CombinedLoader, PrefetchLoader, infinite
from plangen_tpu_torch.data.registry import get_dataset
from plangen_tpu_torch.models.vlm import PlanGenModel
from plangen_tpu_torch.tasks.processor import PlanGenProcessor
from plangen_tpu_torch.train.checkpoint import PlanGenCheckpointer
from plangen_tpu_torch.train.lora import add_lora, init_lora
from plangen_tpu_torch.train.metrics import MetricsLogger
from plangen_tpu_torch.train.optim import count_params, make_optimizer
from plangen_tpu_torch.train.step import init_train_state, make_train_step


def _check_supported(cfg: PlanGenConfig, model_given: bool) -> None:
    tcfg = cfg.train
    if tcfg.fsdp:
        raise NotImplementedError("fsdp is not ported: the port trains on one device")
    if any(size > 1 for size in tcfg.mesh_shape.values()):
        raise NotImplementedError(
            f"mesh_shape {tcfg.mesh_shape}: the port trains on one device")
    if not model_given and cfg.params_path:
        from plangen_tpu_torch.convert.params import read_meta

        form = read_meta(cfg.params_path)["quantize"]  # an orbax one raises
        if form is not None:
            raise ValueError(
                f"params_path={cfg.params_path!r} is a {form} artifact: training needs "
                "dense weights (`cli convert` without --quantize)")


def master_dtype(tcfg) -> torch.dtype:
    dtype = getattr(torch, tcfg.master_dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"master_dtype {tcfg.master_dtype!r} is not a floating dtype")
    return dtype


class Trainer:
    def __init__(self, cfg: PlanGenConfig, model: Optional[PlanGenModel] = None,
                 device: Optional[torch.device] = None):
        validate_config(cfg)
        _check_supported(cfg, model is not None)
        self.cfg = cfg
        tcfg = cfg.train
        if device is None:  # the card, unless the caller asks for another device
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the Trainer runs on the card by default and torch.cuda.is_available() "
                    "is False: pass device='cpu' to train on the CPU")
            device = "cuda"
        self.device = torch.device(device)

        # without a tokenizer in janus_path, the byte-level fallback
        self.tokenizer = load_tokenizer_for(cfg)
        self.processor = PlanGenProcessor(
            self.tokenizer,
            image_tokens=cfg.model.image_seq_len,
            max_seq_len=tcfg.max_seq_len,
            gen=cfg.generation,
        )

        dtype = master_dtype(tcfg)
        if model is None:
            model = PlanGenModel(cfg.model, dtype=dtype, device=self.device)
            if load_params(cfg, model=model) is None:
                g = torch.Generator(device=self.device).manual_seed(tcfg.seed)
                with torch.no_grad():
                    init_params(model, g)
        self.model = model.to(device=self.device, dtype=dtype)
        tuning_mode = tcfg.tuning_mode
        if tuning_mode == "lora":
            add_lora(self.model, tcfg.lora_rank, tcfg.lora_alpha)
            init_lora(self.model, torch.Generator(device=self.device).manual_seed(tcfg.seed + 1))
            if tcfg.tune_token_when_lora and (cfg.use_special_tokens or cfg.use_numhw_tokens):
                tuning_mode = "lora_tokens"
        self.tuning_mode = tuning_mode

        opt, self.mask = make_optimizer(tcfg.optim, self.model, tuning_mode)
        counts = count_params(self.model, self.mask)
        print(f"params: total={counts['total'] / 1e6:.1f}M "
              f"trainable={counts['trainable'] / 1e6:.1f}M "
              f"(tuning_mode={tuning_mode})")
        self._dump_trainable_names()

        self.flows = tuple((i, f.task_type) for i, f in enumerate(tcfg.train_data))
        self.flow_tasks = dict(self.flows)
        self.state = init_train_state(self.model, opt, dtype)
        self.step_fn = make_train_step(
            cfg.model, tcfg, pad_id=self.tokenizer.special.pad_id, flows=self.flows,
            trainable_mask=self.mask,
        )
        self.ckpt = PlanGenCheckpointer(os.path.join(tcfg.output_dir, "checkpoints"),
                                        total_limit=tcfg.checkpoints_total_limit)
        self.logger = MetricsLogger(tcfg.output_dir)

    def _dump_trainable_names(self) -> None:
        """Trainable parameter names and shapes to params.jsonl."""
        os.makedirs(self.cfg.train.output_dir, exist_ok=True)
        with open(os.path.join(self.cfg.train.output_dir, "params.jsonl"), "w") as f:
            for name, p in self.model.named_parameters():
                if self.mask[name]:
                    f.write(json.dumps({"name": name, "shape": list(p.shape)}) + "\n")

    # ------------------------------------------------------------------ data

    def build_dataloader(self):
        tcfg = self.cfg.train
        loaders = {}
        for fid, flow in enumerate(tcfg.train_data):
            ds = get_dataset(self.cfg, flow.data_name, is_test=False)
            loaders[fid] = BatchLoader(ds, flow.batch_size, shuffle=True, seed=tcfg.seed + fid,
                                       workers=tcfg.num_workers)
            print(f"flow {fid}: task={flow.task_type} data={flow.data_name} "
                  f"len={len(ds)} bs={flow.batch_size}")
        combined = CombinedLoader(loaders)
        if tcfg.prefetch_depth > 0:
            combined = PrefetchLoader(combined, depth=tcfg.prefetch_depth)
        return combined

    def device_batches(self, flow_samples):
        batches = collate_flows(flow_samples, self.flow_tasks, self.processor)
        return {fid: {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                      for k, v in b.items()} for fid, b in batches.items()}

    # ----------------------------------------------------------------- train

    def maybe_resume(self) -> int:
        if self.cfg.train.resume is None:
            return 0
        restored = self.ckpt.restore(self.state)
        if restored is None:
            return 0
        print(f"resumed from step {restored.step}")
        return restored.step

    def fit(
        self,
        max_steps: Optional[int] = None,
        validate_fn=None,  # callable(step, model) for the validation cadence
    ) -> Dict[str, float]:
        tcfg = self.cfg.train
        max_steps = max_steps or tcfg.max_train_steps
        start = self.maybe_resume()
        loader = infinite(self.build_dataloader())
        last_metrics: Dict[str, float] = {}
        t_step = time.perf_counter()
        last_logged = start - 1
        for step in range(start, max_steps):
            batches = self.device_batches(next(loader))
            self.state, metrics = self.step_fn(self.state, batches)
            if (step + 1) % 10 == 0 or step == start:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = (time.perf_counter() - t_step) / max(1, step - last_logged)
                t_step = time.perf_counter()
                last_logged = step
                metrics["sec_per_step"] = dt
                self.logger.log(step + 1, metrics)
                last_metrics = metrics
                # a non-finite loss has already poisoned the Adam state: save
                # a post-mortem checkpoint and stop
                if not np.isfinite(metrics["loss"]):
                    self.ckpt.save(step + 1, self.state)
                    raise FloatingPointError(
                        f"non-finite loss {metrics['loss']} at step {step + 1}"
                        f" (metrics: {metrics}); state checkpointed for post-mortem")
            if (step + 1) % tcfg.checkpointing_steps == 0:
                self.ckpt.save(step + 1, self.state)
            if validate_fn is not None and (step + 1) % tcfg.validation_steps == 0:
                validate_fn(step + 1, self.model)
        if self.ckpt.latest_step() != max_steps:
            self.ckpt.save(max_steps, self.state)
        return last_metrics

    def validate(self, step: int, model: Optional[PlanGenModel] = None,
                 max_len: Optional[int] = None) -> None:
        """Run the evaluation harness on `train.test_data` for `max_len`
        (default `train.val_max_len`) batches with the trainer's model;
        layout and image metrics go to the training log under `val/` keys.
        The model is left in training mode; a `generation.quantize` form
        that rewrites weights in place (int8, int4, int4_a8) runs on a copy."""
        from plangen_tpu_torch.ops.quant import MODES
        from plangen_tpu_torch.tasks.eval import run_validation

        td = self.cfg.train.test_data
        model = self.model if model is None else model
        if self.cfg.generation.quantize in MODES and self.cfg.generation.quantize != "int8_kv":
            model = copy.deepcopy(model)
        was_training = model.training
        try:
            run_validation(
                self.cfg,
                task_type=td.task_type,
                data_name=td.data_name,
                max_len=self.cfg.train.val_max_len if max_len is None else max_len,
                output_dir=os.path.join(self.cfg.train.output_dir, "val"),
                batch_size=td.batch_size,
                model=model,
                global_step=step,
                metrics_cb=lambda agg: self.logger.log(
                    step, {f"val/{k}": v for k, v in agg.items()}),
                device=self.device,
            )
        finally:
            model.train(was_training)
