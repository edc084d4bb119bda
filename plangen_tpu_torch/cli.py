"""Command line: serve, train, eval, metrics and doctor, with dotted-key
config overrides.

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
`convert` and `export` are not ported and raise `NotImplementedError`
naming what is missing; the JAX package's TPU probe and compile cache have
no counterpart.
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


def _not_ported(what: str):
    def cmd(args) -> None:
        raise NotImplementedError(
            f"{args.cmd}: not ported to plangen_tpu_torch yet ({what}); "
            f"the JAX package has it: `python -m plangen_tpu.cli {args.cmd}`")
    return cmd


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

    for name, what in (
        ("convert", "orbax artifacts need jax; the port loads HF checkouts directly"),
        ("export", "the export command; convert/export.py has the state-dict exporter"),
    ):
        px = sub.add_parser(name, help=f"not ported ({what})")
        px.add_argument("rest", nargs=argparse.REMAINDER)
        px.set_defaults(fn=_not_ported(what))

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
