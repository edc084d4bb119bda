"""Command line: serve, train, eval, metrics, convert, export and doctor,
with dotted-key config overrides.

Port of `plangen_tpu/cli.py`. Configs are Python modules exporting
`CONFIG: PlanGenConfig` (or a dict `OVERRIDES` applied to the default
config), and `--opt` fragments deep-merge the same way:

    python -m plangen_tpu_torch.cli serve --opt generation.quantize=auto
    python -m plangen_tpu_torch.cli train --opt train.max_train_steps=100

A config module may build its `CONFIG` from the JAX package's
`plangen_tpu.config` (the repo's `configs/*.py` do): `load_config` turns
those dataclasses into the port's copies, which have the same fields.

`serve`, `train`, `eval` and `metrics` run on the card unless `--device`
names another (`cpu`); without a card they exit non-zero. `eval` runs
`tasks/eval.py::run_validation` (a task mode over a dataset, the artifact
tree and its metrics); `metrics` computes FID / KID between two image
directories. `train` validates on `train.test_data` every
`train.validation_steps` steps (0 turns it off), as the JAX CLI does.
`doctor` reports torch, CUDA, the card, nvcc and the kernel builds.
`convert` writes the port's weight artifact (`convert/params.py`) from a
local checkout, quantized or not, with the JAX arguments (and `--cfg` /
`--opt` for the model config, `--device`), refusing an `--out` that holds
anything but an artifact, as orbax does; `export` writes the
weights a config names as the reference's torch state dict, full or a
tuning mode's trainable part. Both run on the card unless `--device cpu`.
The JAX package's TPU probe and compile cache have no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from typing import Any, Optional

from plangen_tpu_torch import config as port_config
from plangen_tpu_torch.config import FlowConfig, PlanGenConfig, apply_overrides, parse_opt_list


def _as_port(value: Any) -> Any:
    """`value` with every dataclass instance of another module's config
    (the JAX package's) made the port's dataclass of the same name."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = getattr(port_config, type(value).__name__)
        if type(value) is cls:
            return value
        return cls(**{f.name: _as_port(getattr(value, f.name))
                      for f in dataclasses.fields(value) if f.init})
    if isinstance(value, (list, tuple)):
        return type(value)(_as_port(v) for v in value)
    if isinstance(value, dict):
        return {k: _as_port(v) for k, v in value.items()}
    return value


def load_config(cfg_path: Optional[str], opts: list) -> PlanGenConfig:
    cfg = PlanGenConfig()
    if cfg_path:
        spec = importlib.util.spec_from_file_location("user_cfg", cfg_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if hasattr(mod, "CONFIG"):
            cfg = _as_port(mod.CONFIG)
        elif hasattr(mod, "OVERRIDES"):
            cfg = apply_overrides(cfg, _as_port(mod.OVERRIDES))
        else:
            raise ValueError(f"{cfg_path} must export CONFIG or OVERRIDES")
    if opts:
        cfg = apply_overrides(cfg, parse_opt_list(opts))
    # train_data entries given as dicts become FlowConfigs
    flows = tuple(f if isinstance(f, FlowConfig) else FlowConfig(**f)
                  for f in cfg.train.train_data)
    if flows != cfg.train.train_data:
        cfg = apply_overrides(cfg, {"train.train_data": flows})
    # ... and test_data, a single flow
    if isinstance(cfg.train.test_data, dict):
        cfg = apply_overrides(cfg, {"train.test_data": FlowConfig(**cfg.train.test_data)})
    return cfg


def _device(args):
    """`--device`, or the card; exits non-zero when there is no card and
    `--device` names none other."""
    from plangen_tpu_torch.tasks.eval import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"{args.cmd}: {e} (--device cpu)")


def cmd_train(args) -> None:
    from plangen_tpu_torch.train.trainer import Trainer

    device = _device(args)
    cfg = load_config(args.cfg, args.opt)
    trainer = Trainer(cfg, device=device)
    # in-training validation at train.validation_steps (0 turns it off)
    validate_fn = trainer.validate if cfg.train.validation_steps > 0 else None
    metrics = trainer.fit(max_steps=args.max_steps, validate_fn=validate_fn)
    print(json.dumps({"final": metrics}))


def cmd_eval(args) -> None:
    from plangen_tpu_torch.tasks.eval import run_validation

    device = _device(args)
    cfg = load_config(args.cfg, args.opt)
    run_validation(cfg, task_type=args.task, data_name=args.data, max_len=args.max_len,
                   output_dir=args.output, device=device)


def cmd_metrics(args) -> None:
    """FID / KID between two image directories (the gt_image/ and pr_image/
    trees an eval run writes), one JSON line keyed by the feature model:
    the model's own SigLIP tower by default (relative comparison only), or
    `--features torch:<path>`, a TorchScript feature module."""
    from plangen_tpu_torch.tasks.image_metrics import (
        fid_kid_from_features, load_image_dir, make_featurizer,
    )

    device = _device(args)
    cfg = load_config(args.cfg, args.opt)
    model = None
    if args.features == "siglip":
        # the featurizer reads only the vision tower: the weights, without
        # the tokenizer or a serving form
        from plangen_tpu_torch.tasks.eval import load_model

        model = load_model(cfg, device).eval()
    try:
        feat, tag = make_featurizer(args.features, model, cfg.model, batch_size=args.batch,
                                    size=args.feature_size, device=device)
    except (ValueError, RuntimeError, OSError) as e:
        sys.exit(f"metrics: {e}")
    gt = feat(load_image_dir(args.gt_dir, limit=args.limit))
    pr = feat(load_image_dir(args.pr_dir, limit=args.limit))
    print(json.dumps(fid_kid_from_features(gt, pr, tag=tag)))


def cmd_serve(args) -> None:
    from plangen_tpu_torch.serve import serve

    device = _device(args)
    cfg = load_config(args.cfg, args.opt)
    serve(cfg, host=args.host, port=args.port, max_batch=args.max_batch,
          wait_ms=args.wait_ms, min_batch=args.min_batch, warmup_spec=args.warmup,
          device=device)


def cmd_convert(args) -> None:
    """A local Janus-Pro checkout (+ an optional PlanGen fine-tune overlay)
    -> the port's weight artifact (`convert/params.py`), which `params_path`
    loads; `--quantize` writes a quantized serving artifact (int4 is ~4x
    smaller on disk and skips quantization at load time). The weights are
    read, quantized and stored in fp32, as the JAX converter reads them;
    `--out` must be new, an empty directory or an artifact."""
    import torch

    from plangen_tpu_torch.convert.loading import load_params
    from plangen_tpu_torch.convert.params import check_destination, save_params
    from plangen_tpu_torch.ops.quant import quantize_model_

    device = _device(args)
    cfg = load_config(args.cfg, args.opt)
    cfg = dataclasses.replace(cfg, janus_path=args.janus_path, finetune_path=args.finetune,
                              params_path=None)
    try:
        check_destination(os.path.abspath(args.out))
    except FileExistsError as e:
        sys.exit(f"convert: {e}")
    model = load_params(cfg, device=device, dtype=torch.float32)
    if model is None:
        sys.exit(f"convert: no weights in --janus-path {args.janus_path!r}")
    if args.quantize:
        quantize_model_(model, args.quantize, eager=True)  # as JAX's convert: eagerly
    out = save_params(model, args.out)
    n = sum(t.numel() for t in model.state_dict().values())
    print(json.dumps({"saved": out, "params_m": round(n / 1e6, 1)}))


def cmd_export(args) -> None:
    """Weights back to the reference's torch world: the full HF state dict,
    or only a tuning mode's trainable part, i.e. a reference-compatible
    `trainable_model_parameters.pth` (base_system.py:166-189). The inverse
    of loading a checkout: the weights `--cfg` / `--opt` name, in fp32."""
    import torch

    from plangen_tpu_torch.convert.export import model_state_dict, save_torch_state_dict
    from plangen_tpu_torch.convert.loading import load_params

    device = _device(args)
    cfg = load_config(args.cfg, args.opt)
    # export wants the dense fp32 values, not the serving cast
    model = load_params(cfg, device=device, dtype=torch.float32)
    if model is None:
        sys.exit("export: no weights configured — set params_path (the port's "
                 "artifact) or janus_path (torch checkpoint dir) via --opt/--cfg")
    try:
        sd = model_state_dict(model, args.trainable)
        out = save_torch_state_dict(sd, args.out)
    except ValueError as e:  # quantized model / unknown mode / bad extension
        sys.exit(f"export: {e}")
    total = sum(int(v.size) for v in sd.values())
    print(json.dumps({"saved": out, "keys": len(sd),
                      "params_m": round(total / 1e6, 1),
                      "trainable": args.trainable,
                      # bf16 sources upcast: fp32 values, 2x bf16 disk size
                      "dtype": "float32 (bf16 params upcast on export)"}))


def cmd_doctor(args) -> None:
    """Is this machine ready to serve and train? One line per check, then
    one JSON line; exits non-zero when a required check fails."""
    import platform

    import torch

    from plangen_tpu_torch import __version__

    report: dict = {"checks": {}}
    ok = True

    def check(name, passed, detail, required=True):
        nonlocal ok
        status = "ok" if passed else ("FAIL" if required else "warn")
        ok = ok and (passed or not required)
        print(f"[{status:4}] {name}: {detail}")
        report["checks"][name] = {"ok": bool(passed), "detail": detail,
                                  "required": bool(required)}

    report["versions"] = {"plangen_tpu_torch": __version__,
                          "python": platform.python_version(),
                          "torch": torch.__version__, "cuda": torch.version.cuda}
    check("torch", True, f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    has_card = torch.cuda.is_available()
    if has_card:
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            smi = f"nvidia-smi failed: {type(e).__name__}"
        check("card", True, f"{torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()} ({smi})")
    else:
        check("card", False, "torch.cuda.is_available() is False")

    from plangen_tpu_torch.kernels.build import KernelBuildError, find_nvcc

    try:
        nvcc = find_nvcc()
        check("nvcc", True, nvcc)
    except KernelBuildError as e:
        nvcc = None
        check("nvcc", False, str(e))
    if has_card and nvcc is not None and not args.no_build:
        from plangen_tpu_torch.kernels import load_libraries

        sources = ("prefix_decode_attention", "int4_matmul", "flash_attention")
        try:
            built = load_libraries(sources)
            check("kernels", True, ", ".join(
                f"{name} {lib.build_seconds:.1f} s" for name, lib in built.items()))
        except (KernelBuildError, OSError) as e:
            check("kernels", False, f"{type(e).__name__}: {e}")

    if args.cfg or args.opt:
        from plangen_tpu_torch.config import validate_config

        try:
            cfg = validate_config(load_config(args.cfg, args.opt))
            check("config", True, f"loaded ({args.cfg or 'defaults'}), "
                  f"tuning={cfg.train.tuning_mode} "
                  f"quantize={cfg.generation.quantize or 'bf16'}")
        except (ValueError, TypeError, KeyError, OSError) as e:
            check("config", False, f"{type(e).__name__}: {e}")
            cfg = None
        if cfg is not None:
            for name in ("janus_path", "params_path", "finetune_path"):
                path = getattr(cfg, name)
                if path is not None:
                    check(name, os.path.exists(path),
                          path if os.path.exists(path) else f"{path} does not exist")

    report["ok"] = ok
    print(json.dumps(report))
    if not ok:
        sys.exit(1)


def main(argv=None) -> None:
    from plangen_tpu_torch import __version__

    p = argparse.ArgumentParser(prog="plangen_tpu_torch")
    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="multi-task training")
    pt.add_argument("--cfg", default=None)
    pt.add_argument("--opt", nargs="*", default=[])
    pt.add_argument("--max-steps", type=int, default=None)
    pt.add_argument("--device", default=None, help="cuda (default) or cpu")
    pt.set_defaults(fn=cmd_train)

    ps = sub.add_parser("serve", help="microbatching HTTP inference server")
    ps.add_argument("--cfg", default=None)
    ps.add_argument("--opt", nargs="*", default=[])
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8000)
    ps.add_argument("--max-batch", type=int, default=32)
    ps.add_argument("--warmup", default=None,
                    help="drive (mode, bucket) batches before taking traffic, "
                         "e.g. 'generate:32,plan:8'")
    ps.add_argument("--min-batch", type=int, default=1,
                    help="floor the batch bucket (light load pays padding)")
    ps.add_argument("--wait-ms", type=float, default=20.0)
    ps.add_argument("--device", default=None, help="cuda (default) or cpu")
    ps.set_defaults(fn=cmd_serve)

    pd = sub.add_parser("doctor", help="operability diagnostic (card, nvcc, kernels, config)")
    pd.add_argument("--cfg", default=None)
    pd.add_argument("--opt", nargs="*", default=[])
    pd.add_argument("--no-build", action="store_true", help="skip building the kernels")
    pd.set_defaults(fn=cmd_doctor)

    pe = sub.add_parser("eval", help="run a task-mode evaluation")
    pe.add_argument("--cfg", default=None)
    pe.add_argument("--opt", nargs="*", default=[])
    pe.add_argument("--task", default="uni",
                    choices=["uni", "uni_2stage", "mmu", "plan", "edit", "rm", "t2i"])
    pe.add_argument("--data", default="toy")
    pe.add_argument("--max-len", "--max_len", dest="max_len", type=int, default=20)
    pe.add_argument("--output", default="out/eval")
    pe.add_argument("--device", default=None, help="cuda (default) or cpu")
    pe.set_defaults(fn=cmd_eval)

    pm = sub.add_parser("metrics", help="FID/KID (SigLIP features) between two image dirs")
    pm.add_argument("gt_dir", help="reference images (eval gt_image/ tree)")
    pm.add_argument("pr_dir", help="generated images (eval pr_image/ tree)")
    pm.add_argument("--cfg", default=None)
    pm.add_argument("--opt", nargs="*", default=[])
    pm.add_argument("--batch", type=int, default=16)
    pm.add_argument("--limit", type=int, default=None,
                    help="cap images per side (sorted filename order)")
    pm.add_argument("--features", default="siglip",
                    help="'siglip' (default, relative-only) or 'torch:<path>', an "
                         "external TorchScript feature module (e.g. scripted "
                         "pytorch-fid InceptionV3) for literature-comparable FID")
    pm.add_argument("--feature-size", type=int, default=299,
                    help="input resolution the torch: feature module expects "
                         "(Inception pool3: 299)")
    pm.add_argument("--device", default=None, help="cuda (default) or cpu")
    pm.set_defaults(fn=cmd_metrics)

    pc = sub.add_parser("convert", help="torch Janus checkpoint -> the port's weight artifact")
    pc.add_argument("--janus-path", required=True)
    pc.add_argument("--finetune", default=None,
                    help="trainable_model_parameters.pth overlay")
    pc.add_argument("--out", default="converted_params")
    pc.add_argument("--quantize", default=None, choices=["int8", "int4", "int4_a8"],
                    help="write a quantized serving artifact")
    pc.add_argument("--cfg", default=None, help="the model config (default Janus-Pro-1B)")
    pc.add_argument("--opt", nargs="*", default=[])
    pc.add_argument("--device", default=None, help="cuda (default) or cpu")
    pc.set_defaults(fn=cmd_convert)

    px = sub.add_parser("export", help="params -> torch state dict (reference finetune format)")
    px.add_argument("--cfg", default=None)
    px.add_argument("--opt", nargs="*", default=[])
    px.add_argument("--out", default="trainable_model_parameters.pth",
                    help=".pth/.pt/.bin (torch), .safetensors, or .npz")
    px.add_argument("--trainable", default=None,
                    help="export only this tuning mode's trained subtree "
                         "(stage1/stage2/stage3/lm/lora/lora_tokens/all); "
                         "omit for the full state dict")
    px.add_argument("--device", default=None, help="cuda (default) or cpu")
    px.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
