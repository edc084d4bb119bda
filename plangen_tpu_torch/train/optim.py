"""Optimizer construction: AdamW or Adafactor + clip + trainable-subset
masking, with gradient accumulation.

Port of `plangen_tpu/train/optim.py`. The recipe (cfg/base.py:53-60): AdamW
lr 5e-5, betas (0.9, 0.999), eps 1e-8, weight decay 0.01, gradient clip 1.0,
constant schedule with optional warmup. Tuning modes freeze parameters by
name, as the JAX package's path predicates do:

  all         — everything trainable
  lm          — language_model only
  stage1      — aligner + gen_aligner + gen_head
  stage2      — all but vision_model and gen_vision_model
  stage3      — all but gen_vision_model        (the released recipe)
  lora        — the LoRA adapters only (`train/lora.py`; `lora_scaling`
                stays frozen)
  lora_tokens — the adapters and the token embeddings

Each optimizer computes what the JAX package's
`masked(chain(clip_by_global_norm, inner))` + `masked(set_to_zero)` computes
in optax: the global norm covers the trainable set only, frozen parameters
get no update and no decay, and the state exists for trainable parameters
only. `AdamW` is `optax.adamw`; `Adafactor` is `optax.adafactor(lr,
multiply_by_parameter_scale=False, momentum=None,
weight_decay_rate=adam_weight_decay * learning_rate)`; `Accumulate` is
`optax.MultiSteps` around either. The state lives in the parameters' dtype
(the master dtype), and every Python scalar meets a tensor rounded to that
dtype, as a weakly typed scalar meets an array in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

from plangen_tpu_torch.config import OptimConfig
from plangen_tpu_torch.parallel.mesh import STACKED, jax_axes, split_dim

_LORA = ".lora."  # the adapters' names: ...self_attn.lora.<target>.{a, b}
TUNING_MODES: Dict[str, Callable[[str], bool]] = {
    "all": lambda p: True,
    "lm": lambda p: p.startswith("language_model"),
    "stage1": lambda p: p.startswith(("aligner", "gen_aligner", "gen_head")),
    "stage2": lambda p: not p.startswith(("vision_model", "gen_vision_model")),
    "stage3": lambda p: not p.startswith("gen_vision_model"),
    "lora": lambda p: _LORA in p,
    "lora_tokens": lambda p: _LORA in p or p == "language_model.model.embed_tokens.weight",
}

Grads = Dict[str, Optional[torch.Tensor]]


def trainable_mask(model: nn.Module, tuning_mode: str) -> Dict[str, bool]:
    """{parameter name: trainable} under the given tuning mode."""
    if tuning_mode not in TUNING_MODES:
        raise ValueError(
            f"unknown tuning_mode {tuning_mode!r}; options: {sorted(TUNING_MODES)}")
    pred = TUNING_MODES[tuning_mode]
    return {name: pred(name) for name, _ in model.named_parameters()}


def count_params(model: nn.Module, mask: Optional[Dict[str, bool]] = None) -> Dict[str, int]:
    """Trainable/frozen parameter counts."""
    sizes = {name: p.numel() for name, p in model.named_parameters()}
    total = sum(sizes.values())
    if mask is None:
        return {"total": total, "trainable": total}
    return {"total": total, "trainable": sum(s for n, s in sizes.items() if mask[n])}


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """step -> learning rate, as the optax schedules the JAX package builds."""
    lr, warmup = cfg.learning_rate, cfg.lr_warmup_steps

    def linear(step: int) -> float:  # optax.linear_schedule(0, lr, warmup)
        return lr * min(max(step, 0), warmup) / warmup

    if cfg.lr_scheduler == "constant":
        return linear if warmup > 0 else (lambda step: lr)
    if cfg.lr_scheduler == "cosine":
        decay = 1_000_000 - warmup  # warmup_cosine_decay_schedule(0, lr, w, 1e6)

        def cosine(step: int) -> float:
            if step < warmup:
                return linear(step)
            t = min(step - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return cosine
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler}")


def _in(x: float, dtype: torch.dtype) -> float:
    """The Python scalar x as a value of `dtype`."""
    return torch.tensor(x, dtype=dtype).item()


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself otherwise): the updates
    are elementwise, so each rank updates its shard in place."""
    return t.to_local() if isinstance(t, DTensor) else t


def placed_like(grads: Grads, params: Dict[str, torch.Tensor]) -> Grads:
    """The gradients of DTensor parameters laid out as their parameters
    are (autograd may hand back another placement, such as the whole
    gradient of a vocab-parallel embedding)."""
    out = dict(grads)
    for n, p in params.items():
        g = grads.get(n)
        if isinstance(g, DTensor) and g.placements != p.placements:
            out[n] = g.redistribute(p.device_mesh, p.placements)
    return out


def global_sq_norm(tensors) -> torch.Tensor:
    """The sum of squares over every element of the tensors, in their
    dtype: a DTensor's shards are summed over the mesh dims (of more than
    one rank) that split it, so each element counts once, and a replicated
    tensor counts once. A DTensor whole on its ranks adds in the order of a
    plain tensor, so that a world-1 mesh gives the unsplit model's bits."""
    total = None
    split: Dict[tuple, torch.Tensor] = {}  # the process groups that split a sum
    for t in tensors:
        s = torch.sum(_local(t) * _local(t))
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            key = tuple(mesh.get_group(d) for d, pl in enumerate(t.placements)
                        if split_dim(pl) is not None and mesh.size(d) > 1)
            if key:
                split[key] = s if key not in split else split[key] + s
                continue
        total = s if total is None else total + s
    for groups, s in split.items():
        for group in groups:
            dist.all_reduce(s, group=group)
        total = s if total is None else total + s
    return total


class _Masked:
    """The trainable parameters of a model whose masters it updates in
    place, after optax's clip_by_global_norm. Subclasses yield the updates."""

    def __init__(self, cfg: OptimConfig, model: nn.Module, mask: Dict[str, bool]):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.params = {n: p for n, p in model.named_parameters() if mask[n]}
        self.count = 0  # updates so far

    @torch.no_grad()
    def step(self, grads: Grads) -> None:
        """One update from {name: gradient} (None = zero gradient). The
        gradients are clipped (and may be overwritten) in place. A DTensor
        parameter (TP, FSDP2) is updated shard by shard, its state sharded
        with it, and the clip takes the global norm."""
        for _, p, u in self.updates(grads):
            _local(p).add_(u)  # apply_updates

    def updates(self, grads: Grads) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor]]:
        raise NotImplementedError

    def _clipped(self, grads: Grads) -> Dict[str, torch.Tensor]:
        """clip_by_global_norm: t / norm * max_norm unless norm < max_norm."""
        grads = placed_like(grads, self.params)
        g = {n: _local(grads[n]) if grads.get(n) is not None else torch.zeros_like(_local(p))
             for n, p in self.params.items()}
        norm = torch.sqrt(global_sq_norm([grads[n] if grads.get(n) is not None else g[n]
                                          for n in self.params]))
        if not bool(norm < self.cfg.max_grad_norm):
            for t in g.values():
                t.div_(norm.to(t.dtype)).mul_(_in(self.cfg.max_grad_norm, t.dtype))
        return g


class AdamW(_Masked):
    """optax's clip_by_global_norm + adamw."""

    def __init__(self, cfg: OptimConfig, model: nn.Module, mask: Dict[str, bool]):
        super().__init__(cfg, model, mask)
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def updates(self, grads: Grads) -> Iterator:
        """Advance the moments and yield (name, parameter, update) for each
        trainable parameter; `step` adds each update to its parameter."""
        cfg = self.cfg
        g = self._clipped(grads)
        # scale_by_adam, with the bias corrections in fp32 as optax computes them
        t = self.count + 1
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        bc1 = float(1 - _f32(b1) ** t)
        bc2 = float(1 - _f32(b2) ** t)
        lr = self.schedule(self.count)
        for n, p in self.params.items():
            d = p.dtype
            p = _local(p)
            mu, nu = _local(self.mu[n]), _local(self.nu[n])
            mu.mul_(_in(b1, d)).add_(_in(1 - b1, d) * g[n])
            nu.mul_(_in(b2, d)).add_(_in(1 - b2, d) * (g[n] * g[n]))
            u = (mu / _in(bc1, d)) / (torch.sqrt(nu / _in(bc2, d)) + _in(cfg.adam_epsilon, d))
            u = u + _in(cfg.adam_weight_decay, d) * p  # add_decayed_weights
            yield n, p, u * _in(-lr, d)  # scale_by_learning_rate
        self.count = t

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for n in self.params:
            self.mu[n].copy_(sd["mu"][n])
            self.nu[n].copy_(sd["nu"][n])


# ---------------------------------------------------------------- Adafactor


def _jax_leaves(model: nn.Module, names) -> Dict[str, Tuple[bool, List[Tuple[str, tuple]]]]:
    """Group parameter names by the JAX leaf that holds them: {leaf key:
    (stacked, [(name, axes into the JAX layout)])}, a stacked leaf's names
    in layer order under `<prefix>.*.<rest>`."""
    axes = jax_axes(model)
    groups: Dict[str, list] = {}
    for name in names:
        m = STACKED.match(name)
        key, index = (f"{m[1]}.*.{m[3]}", int(m[2])) if m else (name, -1)
        groups.setdefault(key, []).append((index, name))
    return {key: (members[0][0] >= 0, [(name, axes.get(name, ())) for _, name in sorted(members)])
            for key, members in groups.items()}


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims`: the two largest axes (second largest, then
    largest), or None when the second largest is under the threshold."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _inverse(axes: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(int(i) for i in np.argsort(axes))


def _jax_dim(dim: int, axes: Tuple[int, ...], stacked: bool) -> int:
    """The dim of a leaf in the JAX layout that a member's dim `dim` is."""
    return (axes.index(dim) if axes else dim) + int(stacked)


def _split_dims(p: torch.Tensor, axes, stacked: bool) -> Dict[int, list]:
    """{dim of the JAX-layout leaf: the process groups of every mesh dim (of
    more than one rank) that splits it} for a member parameter; empty for a
    plain tensor or a DTensor whole on its ranks."""
    out: Dict[int, list] = {}
    if isinstance(p, DTensor):
        mesh = p.device_mesh
        for i, pl in enumerate(p.placements):
            if split_dim(pl) is not None and mesh.size(i) > 1:
                out.setdefault(_jax_dim(pl.dim, axes, stacked), []).append(mesh.get_group(i))
    return out


def _mean(t: torch.Tensor, dims, groups, size: int, keepdim: bool = False) -> torch.Tensor:
    """The mean of `t` (a rank's shard) over `dims` (None: every dim) whose
    whole extent holds `size` elements: the local mean when no process
    group splits them, else the local sum, summed over `groups`, over
    `size` (a shard holds no padding, so none enters the mean)."""
    if not groups:
        return t.mean() if dims is None else t.mean(dim=dims, keepdim=keepdim)
    total = t.sum() if dims is None else t.sum(dim=dims, keepdim=keepdim)
    for group in groups:
        dist.all_reduce(total, group=group)
    return total / size


def _state(local: torch.Tensor, like: torch.Tensor, axes, stacked: bool,
           shape: Tuple[int, ...], drop: Optional[int] = None) -> torch.Tensor:
    """A statistic of a JAX-layout leaf of global `shape` (less its dim
    `drop`) as its member parameter `like` is placed: a DTensor whose dims
    are split as the parameter's are and whole over a mesh dim that splits
    the dropped dim (its mean was summed over those ranks); the local
    tensor itself for a plain parameter."""
    if not isinstance(like, DTensor):
        return local
    placements = []
    for pl in like.placements:
        j = _jax_dim(pl.dim, axes, stacked) if split_dim(pl) is not None else None
        if j is None or j == drop:
            placements.append(Replicate() if j is not None else pl)
            continue
        j -= int(drop is not None and j > drop)
        placements.append(_StridedShard(j, split_factor=pl.split_factor)
                          if isinstance(pl, _StridedShard) else Shard(j))
    shape = tuple(n for d, n in enumerate(shape) if d != drop)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, like.device_mesh, placements, shape=shape, stride=stride)


class Adafactor(_Masked):
    """optax's clip_by_global_norm + adafactor(lr, multiply_by_parameter_scale
    =False, momentum=None, weight_decay_rate=wd * lr): the factored second
    moment (decay 1 - t^-0.8, epsilon 1e-30), clip_by_block_rms(1.0), the
    learning rate, then the decay.

    Every statistic is taken over the JAX package's leaf: a layer-stacked
    leaf's per-layer tensors are stacked in the JAX layout before the
    factored means and the block RMS (`_jax_leaves`), and the state is kept
    in that layout.

    Over DTensor parameters (FSDP2 or TP) each rank works on its shards,
    every layer's covering the same range: a mean over a dim that
    the parameter's placement splits is the local sum, summed over the mesh
    dims that split it, over the whole dim's size (`_mean`), so every rank
    gets the unsplit statistic of its shard; `v_row`, `v_col` and `v` are
    DTensors placed as the dims they keep (`_state`), so that the
    checkpoint gathers them whole in the JAX layout."""

    DECAY_RATE = 0.8
    EPSILON = 1e-30
    CLIPPING_THRESHOLD = 1.0

    def __init__(self, cfg: OptimConfig, model: nn.Module, mask: Dict[str, bool]):
        super().__init__(cfg, model, mask)
        self.weight_decay = cfg.adam_weight_decay * cfg.learning_rate
        self.leaves = _jax_leaves(model, self.params)
        self.shapes: Dict[str, Tuple[int, ...]] = {}  # leaf key -> its whole shape
        self.split: Dict[str, Dict[int, list]] = {}  # leaf key -> `_split_dims`
        self.v_row: Dict[str, torch.Tensor] = {}
        self.v_col: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        for key, (stacked, members) in self.leaves.items():
            name, axes = members[0]
            like = self.params[name]
            shape, local = (tuple(t.permute(axes).shape if axes else t.shape)
                            for t in (like, _local(like)))
            if stacked:
                shape, local = (len(members),) + shape, (len(members),) + local
            self.shapes[key], self.split[key] = shape, _split_dims(like, axes, stacked)
            kw = dict(dtype=like.dtype, device=_local(like).device)
            dims = factored_dims(shape)
            if dims is None:
                self.v[key] = _state(torch.zeros(local, **kw), like, axes, stacked, shape)
            else:
                d1, d0 = dims
                for state, drop in ((self.v_row, d0), (self.v_col, d1)):
                    zeros = torch.zeros(np.delete(local, drop).tolist(), **kw)
                    state[key] = _state(zeros, like, axes, stacked, shape, drop)

    @staticmethod
    def _to_jax(stacked: bool, members, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        views = [tensors[n].permute(axes) if axes else tensors[n] for n, axes in members]
        return torch.stack(views) if stacked else views[0]

    @torch.no_grad()
    def updates(self, grads: Grads) -> Iterator:
        g = self._clipped(grads)
        step = _f32(self.count + 1)
        decay = 1.0 - step ** -self.DECAY_RATE  # fp32, as optax's _decay_rate_pow
        lr = self.schedule(self.count)
        for key, (stacked, members) in self.leaves.items():
            u = self._leaf_update(key, self._to_jax(stacked, members, g), decay)
            # clip_by_block_rms over the whole leaf, then the learning rate
            d = u.dtype
            groups = [gr for dim_groups in self.split[key].values() for gr in dim_groups]
            mean_sq = _mean(u * u, None, groups, int(np.prod(self.shapes[key])))
            rms = torch.sqrt(mean_sq) / _in(self.CLIPPING_THRESHOLD, d)
            u = u / torch.clamp(rms, min=_in(1.0, d))
            u = u * _in(lr, d)
            for i, (name, axes) in enumerate(members):
                p = self.params[name]
                ui = u[i] if stacked else u
                ui = ui.permute(_inverse(axes)) if axes else ui
                if self.weight_decay:
                    ui = ui + _in(self.weight_decay, d) * _local(p)  # add_decayed_weights
                yield name, p, -ui
        self.count += 1

    def _leaf_update(self, key: str, grad: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
        """scale_by_factored_rms on one leaf (JAX layout, this rank's shard);
        advances its state."""
        dtype = grad.dtype
        shape, split = self.shapes[key], self.split[key]
        grad_sqr = grad * grad + _in(self.EPSILON, dtype)
        dims = factored_dims(shape)
        if dims is None:
            v = _local(self.v[key])
            v.copy_((decay * v.float() + (1.0 - decay) * grad_sqr.float()).to(dtype))
            return grad * v ** -0.5
        d1, d0 = dims
        v_row, v_col = _local(self.v_row[key]), _local(self.v_col[key])
        v_row.copy_((decay * v_row.float() + (1.0 - decay) * _mean(
            grad_sqr, d0, split.get(d0), shape[d0]).float()).to(dtype))
        v_col.copy_((decay * v_col.float() + (1.0 - decay) * _mean(
            grad_sqr, d1, split.get(d1), shape[d1]).float()).to(dtype))
        del grad_sqr
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_mean = _mean(v_row, reduced_d1, split.get(d1), shape[d1], keepdim=True)
        row_factor = (v_row / row_mean) ** -0.5
        col_factor = v_col ** -0.5
        return grad * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

    def state_dict(self) -> dict:
        return {"count": self.count, "v_row": self.v_row, "v_col": self.v_col, "v": self.v}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for name in ("v_row", "v_col", "v"):
            for key, t in getattr(self, name).items():
                t.copy_(sd[name][key])


# ----------------------------------------------------- gradient accumulation


class Accumulate:
    """optax.MultiSteps(inner, k): the running mean of the micro-step
    gradients, `acc + (g - acc) / (n + 1)`, in the parameters' dtype; every
    k-th call hands it to the inner optimizer (which counts one update, for
    its bias correction and its schedule) and starts again from zero. The
    other calls leave the parameters as they are."""

    def __init__(self, inner: _Masked, every_k: int):
        self.inner = inner
        self.every_k = every_k
        self.params = inner.params
        self.mini_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @property
    def count(self) -> int:
        """Updates applied so far (optax's gradient_step)."""
        return self.inner.count

    @torch.no_grad()
    def step(self, grads: Grads) -> None:
        n = self.mini_step
        grads = placed_like(grads, self.params)
        for name, acc in self.acc.items():
            g, acc = grads.get(name), _local(acc)
            acc.add_(((_local(g) if g is not None else torch.zeros_like(acc)) - acc) / (n + 1))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return
        self.inner.step(self.acc)
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": self.acc,
                "inner": self.inner.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.mini_step = int(sd["mini_step"])
        for n, acc in self.acc.items():
            acc.copy_(sd["acc"][n])
        self.inner.load_state_dict(sd["inner"])


OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor}


def make_optimizer(cfg: OptimConfig, model: nn.Module, tuning_mode: str = "stage3"):
    """Returns (optimizer, trainable mask {name: bool})."""
    mask = trainable_mask(model, tuning_mode)
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; options: adamw, adafactor")
    opt = OPTIMIZERS[cfg.optimizer](cfg, model, mask)
    if cfg.gradient_accumulation_steps > 1:
        opt = Accumulate(opt, cfg.gradient_accumulation_steps)
    return opt, mask
