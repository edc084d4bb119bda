"""Device mesh and sharding rules on torch.distributed.

Port of `plangen_tpu/parallel/mesh.py`. One process drives one device, so
the mesh's product is the world size (JAX has one process drive many):

  * `create_mesh(shape)` keeps JAX's axis dict, its -1 wildcard and its
    "needs N devices, have M" assertion, and returns a `DeviceMesh` with
    the dims ("data", "model") on `cuda:{local rank}`, or on the CPU over
    gloo when asked. Without a process group it opens a world-1 one, so
    that FSDP and a 1 x 1 mesh run the same code on one card as on many.
  * "model" (TP) is DTensor tensor parallelism: `parallelize_module`
    (`torch.distributed.tensor.parallel`) with the styles of `_Split`,
    JAX's `_TP_RULES` on the port's HF names. A JAX leaf [L, in, out] is
    one `nn.Linear` weight [out, in] a layer, so JAX's column split is
    `Shard(0)` of the weight. The token embedding is vocab-parallel;
    lm_head, q/k/v, gate/up, SigLIP qkv/fc1 and gen_head's vision_head are
    column-parallel; o_proj/down_proj and SigLIP proj/fc2 row-parallel. A
    column-parallel layer's bias is split with its output (JAX keeps it
    replicated and lets XLA slice it), and SigLIP's fused qkv is split per
    part (`_StridedShard`), so that each rank holds q, k and v of its
    heads. A tensor whose split dim does not divide stays replicated. The
    parameters are DTensors; the forwards run on each rank's local shards
    with explicit collectives, so each rank's layers see H/tp heads as
    plain tensors, and lm_head / vision_head gather their logits whole on
    every rank, so the sampling and the argmax see the full vocabulary.
    The collectives are c10d calls on the current stream, which a CUDA
    graph of a decode step captures.
  * Heads that do not split: where a tower's head count (LLaMA's query or
    KV heads, SigLIP's heads) does not divide by the TP size, that tower's
    attention (q/k/v/o and their LoRA adapters, or SigLIP's qkv/proj)
    stays whole on every rank and runs unsplit, with no collective; its
    MLP, the embedding and the heads still split. JAX splits such a
    projection by its dim and lets GSPMD reshard at the head reshape; the
    port's split forwards need whole heads on a rank (`whole_attention`).
  * LoRA under TP: q/k/v's adapter `b` [r, out] is split with its
    projection's heads and o_proj's `a` [in, r] with its input's; the
    other factors stay whole (JAX replicates every adapter and lets XLA
    make the gradients right; here `TPSplit` says which collectives do).
  * The weight-quantized forms under TP: the packed weights are split, not
    replicated as in JAX (replicating them would undo what TP is for), and
    the function computed stays the unsplit model's. `shard_params` of a
    quantized model cuts each rank's shard out of the whole quantized
    buffers (`_take_shard`); a dense TP model quantized in place
    (`ops/quant.py::quantize_model_`, `int4_view`) quantizes each rank's
    shard, row splits with the whole input dim's absmax
    (`TPSplit.quantized`); both give every rank the same bytes.
  * FSDP over "data" is FSDP2 (`fully_shard`): one unit per LLaMA layer
    and SigLIP block, the rest in the root. As in JAX, a parameter takes a
    TP placement or an FSDP one, never both, and FSDP shards only what
    JAX's rule shards (`fsdp_dim`): a parameter that no TP rule splits
    whose JAX leaf (the layer-stacked [L, ...] array for a LLaMA layer's or
    SigLIP block's tensor, in the JAX layout: a linear weight [in, out], a
    conv weight HWIO) holds `fsdp_min_size` elements or more, along the
    port dim of that leaf's largest dim that divides the "data" size (the
    lower one on a tie). FSDP2 shards it there (`shard_placement_fn`) and
    ignores the rest: the TP-split parameters, which keep their TP
    placement alone, and the replicated ones, plain tensors whole on every
    rank (`fsdp_ignored`: the train step casts them to the compute dtype
    and sums their gradients over the data group itself, and a
    rematerialized unit takes their casts at the recompute too,
    `ops/remat.py`). So a parameter is a DTensor over one mesh dim, or a
    plain tensor, on a 2-D mesh too. `MixedPrecisionPolicy` casts the
    masters to the compute dtype after the all-gather and reduces the
    gradients in fp32, summed over the data group (the losses divide by
    the global token count, `train/loss.py`).
  * The batch: each data shard of the mesh takes its contiguous slice of
    the global batch's rows (`batch_sharding`, `shard_rows`); ranks that
    differ only in their "model" coordinate take the same rows.

`param_placement` is the pure rule (name, shape, tp size, fsdp size,
`fsdp_min_size`, the JAX leaf's layout) that `shard_params` applies, and
`fsdp_dim` the dim FSDP shards, so a test can hold them against JAX's
`param_shardings` without processes.
"""

from __future__ import annotations

import datetime
import functools
import math
import os
import re
import socket
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ParallelStyle, parallelize_module
from torch.distributed.tensor.placement_types import _StridedShard

from plangen_tpu_torch.ops.int4_matmul import pack_int4, unpack_int4
from plangen_tpu_torch.ops.quant import Int8Linear, _QuantLinear

AXES = ("data", "model")
KINDS = ("vocab", "column", "row", "fsdp", "replicated")

# parameter-name pattern -> (the TP kind of its module, the dim it splits,
# the tower whose head count must split for the rule to apply: its
# attention's projections) (JAX's `_TP_RULES`); a weight is nn.Linear's
# [out, in]. The names of the quantized modules' fused projections
# (`ops/quant.py`) match as well.
_BLOCKS = r"^vision_model\.vision_tower\.blocks\.\d+\."
_TP_RULES: Tuple[Tuple[str, str, int, Optional[str]], ...] = (
    (r"^language_model\.model\.embed_tokens\.weight$", "vocab", 0, None),
    (r"^language_model\.lm_head\.weight$", "column", 0, None),
    (r"\.self_attn\.(q_proj|k_proj|v_proj|qkv_proj|k_v_proj)\.weight$", "column", 0, "llama"),
    (r"\.self_attn\.o_proj\.weight$", "row", 1, "llama"),
    (r"\.mlp\.(gate_proj|up_proj|gate_up_proj)\.weight$", "column", 0, None),
    (r"\.mlp\.down_proj\.weight$", "row", 1, None),
    (_BLOCKS + r"attn\.qkv\.(weight|bias)$", "column", 0, "siglip"),
    (_BLOCKS + r"mlp\.fc1\.(weight|bias)$", "column", 0, None),
    (_BLOCKS + r"attn\.proj\.weight$", "row", 1, "siglip"),
    (_BLOCKS + r"mlp\.fc2\.weight$", "row", 1, None),
    (r"^gen_head\.vision_head\.(weight|bias)$", "column", 0, None),
    # the LoRA adapters (a [in, r], b [r, out]): q/k/v's b split with its
    # projection's heads, o_proj's a with the heads of its input; the other
    # factor of each pair stays whole
    (r"\.self_attn\.lora\.(q_proj|k_proj|v_proj)\.b$", "column", 1, "llama"),
    (r"\.self_attn\.lora\.o_proj\.a$", "row", 0, "llama"),
)
_GATHERED = ("language_model.lm_head", "gen_head.vision_head")  # logits, whole
# the parts of a fused output, each split over the ranks as a layer of its own
_PARTS = {"attn.qkv": 3, "qkv_proj": 3, "k_v_proj": 2, "gate_up_proj": 2}


def _parts(module_name: str) -> int:
    return next((n for suffix, n in _PARTS.items() if module_name.endswith(suffix)), 1)


def mesh_dims(shape: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """{"data": d, "model": m} for an axis dict over `n` devices, -1 taking
    the devices left (JAX's `create_mesh`); raises JAX's assertion when the
    mesh needs more than `n`."""
    shape = dict(shape or {"data": -1, "model": 1})
    unknown = sorted(set(shape) - set(AXES))
    if unknown:
        raise ValueError(f"mesh axes {unknown}: the port's mesh has the axes {AXES}")
    known, wild = 1, None
    for k, v in shape.items():
        if v == -1:
            wild = k
        else:
            known *= v
    if wild is not None:
        shape[wild] = max(1, n // known)
    total = 1
    for v in shape.values():
        total *= v
    if total > n:
        raise AssertionError(f"mesh {shape} needs {total} devices, have {n}")
    return {axis: shape.get(axis, 1) for axis in AXES}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[str] = None) -> None:
    """Open the process group: NCCL on the card, or gloo with
    `device="cpu"`. With `coordinator_address` ("host:port") the world size
    and rank are the arguments; without, they come from the launcher's
    environment (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, as `torchrun` sets them), the counterpart of
    `jax.distributed.initialize()`'s autodetection. On the card each
    process takes `cuda:{LOCAL_RANK}` (the rank without a launcher)."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if coordinator_address is None:
        init, rank = "env://", int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init, rank, world = f"tcp://{coordinator_address}", process_id, num_processes
    kw = {}
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed opens NCCL on the card and "
                               "torch.cuda.is_available() is False: pass device='cpu'")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init, rank=rank,
                            world_size=world, timeout=datetime.timedelta(minutes=10), **kw)


def create_mesh(shape: Optional[Dict[str, int]] = None, device=None) -> DeviceMesh:
    """A `DeviceMesh` ("data", "model") over the process group, on the card
    unless `device` is the CPU. Without a process group it opens a world-1
    one over localhost. The mesh must cover the world."""
    device_type = "cuda" if device is None else torch.device(device).type
    if not dist.is_initialized():
        init_distributed(f"localhost:{_free_port()}", 1, 0, device=device_type)
    n = dist.get_world_size()
    dims = mesh_dims(shape, n)
    if dims["data"] * dims["model"] != n:
        raise ValueError(f"mesh {dims} covers {dims['data'] * dims['model']} of the {n} "
                         "processes: one process drives one device, so the mesh's "
                         "product is the world size")
    return init_device_mesh(device_type, (dims["data"], dims["model"]), mesh_dim_names=AXES)


# ------------------------------------------------------------------- rules


def whole_attention(cfg, tp: int) -> FrozenSet[str]:
    """The towers ("llama", "siglip") of a `PlanGenModelConfig` whose
    attention stays whole over a TP axis of size `tp`: their head count
    (LLaMA's query or KV heads) does not divide by it."""
    llama, vision = cfg.llama, cfg.vision
    return frozenset(tower for tower, heads in (
        ("llama", (llama.num_heads, llama.num_kv_heads)), ("siglip", (vision.heads,)))
        if any(h % tp for h in heads))


def _tp_rule(name: str, shape: Sequence[int], tp: int, parts: int = 1,
             whole: FrozenSet[str] = frozenset()) -> Optional[Tuple[str, int]]:
    """(kind, split dim) of the first TP rule that `name` matches, or None
    when none does, its split dim (each of `parts` fused parts of it) does
    not divide by `tp`, or it splits the attention of a tower in `whole`."""
    for pattern, kind, dim, tower in _TP_RULES:
        if re.search(pattern, name):
            if tower in whole or shape[dim] % (tp * parts):
                return None
            return kind, dim
    return None


# one JAX leaf holds a layer-stacked [L, ...] array where the port holds one
# tensor per layer: these prefixes, by layer index
STACKED = re.compile(r"^(language_model\.model\.layers|vision_model\.vision_tower\.blocks)"
                     r"\.(\d+)\.(.+)$")
FSDP_MIN_SIZE = 2 ** 20  # JAX's default `fsdp_min_size`


def jax_axes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{parameter name: the permutation of its axes into the JAX layout}:
    linear weights [out, in] -> [in, out], conv weights OIHW -> HWIO; the
    rest (the LoRA adapters included) as they are."""
    axes = {}
    for mod_name, mod in model.named_modules():
        prefix = mod_name + "." if mod_name else ""
        if isinstance(mod, nn.Linear):
            axes[prefix + "weight"] = (1, 0)
        elif isinstance(mod, nn.Conv2d):
            axes[prefix + "weight"] = (2, 3, 1, 0)
    return axes


def jax_layers(cfg, name: str) -> Optional[int]:
    """The number of layers the JAX leaf holding parameter `name` stacks
    (a `PlanGenModelConfig`'s LLaMA layers or SigLIP blocks), or None when
    that leaf is not stacked."""
    m = STACKED.match(name)
    if m is None:
        return None
    return cfg.llama.num_layers if m[1].startswith("language_model") else cfg.vision.layers


def fsdp_dim(shape: Sequence[int], fsdp: int, fsdp_min_size: int = FSDP_MIN_SIZE,
             axes: Sequence[int] = (), layers: Optional[int] = None) -> Optional[int]:
    """The dim of a parameter of `shape` that FSDP over `fsdp` ranks shards,
    or None when it stays whole: JAX's rule on the parameter's JAX leaf
    (its dims permuted by `axes`, `jax_axes`, behind a stack of `layers`,
    `jax_layers`). A leaf of `fsdp_min_size` elements or more shards along
    its largest dim that divides `fsdp` (the lower dim on a tie); that dim
    is mapped back to the port's. The port cannot split a stack of per-layer
    tensors, so where JAX would take the layer dim it takes JAX's next dim
    that divides. (At size 1 every dim divides, as a TP rule splits over an
    axis of size 1.)"""
    leaf = [shape[a] for a in axes] if axes else list(shape)
    stack = int(layers is not None)
    if stack:
        leaf.insert(0, layers)
    if not leaf or math.prod(leaf) < fsdp_min_size:
        return None
    for d in sorted(range(len(leaf)), key=lambda d: -leaf[d]):  # stable: ties keep order
        if d >= stack and leaf[d] % fsdp == 0:
            d -= stack
            return axes[d] if axes else d
    return None


def param_placement(name: str, shape: Sequence[int], tp: Optional[int] = None,
                    fsdp: Optional[int] = None, whole: FrozenSet[str] = frozenset(),
                    fsdp_min_size: int = FSDP_MIN_SIZE, axes: Sequence[int] = (),
                    layers: Optional[int] = None) -> str:
    """How `shard_params` places one parameter: "vocab", "column", "row"
    (TP over an axis of size `tp`), "fsdp" (FSDP2 over an axis of size
    `fsdp`) or "replicated". None leaves an axis out. A TP rule whose split
    dim does not divide by `tp` leaves the tensor replicated, as in JAX, and
    so does the attention of a tower in `whole` (`whole_attention`), unlike
    JAX; a TP-split parameter takes its TP placement only, as in JAX. Under
    FSDP any other parameter is "fsdp" where `fsdp_dim` (of its JAX leaf's
    layout `axes` / `layers`) gives a dim, as JAX's rule shards its leaf,
    and "replicated" otherwise. (At size 1 a split tensor is whole on its
    one rank, as JAX's replicated one.) The LoRA adapters, which JAX keeps
    replicated under TP, split as the module docstring says."""
    rule = None if tp is None else _tp_rule(name, shape, tp, whole=whole)
    if rule is not None:
        return rule[0]
    if fsdp is not None and fsdp_dim(shape, fsdp, fsdp_min_size, axes, layers) is not None:
        return "fsdp"
    return "replicated"


def _placements(model: nn.Module, tp: Optional[int], fsdp: Optional[int],
                fsdp_min_size: int) -> Dict[str, Tuple[str, Optional[int]]]:
    """{parameter name: (`param_placement`, the dim FSDP shards or None)}."""
    whole = frozenset() if tp is None else whole_attention(model.cfg, tp)
    axes = jax_axes(model)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        layout = dict(axes=axes.get(name, ()), layers=jax_layers(model.cfg, name))
        kind = param_placement(name, shape, tp, fsdp, whole, fsdp_min_size, **layout)
        out[name] = (kind, fsdp_dim(shape, fsdp, fsdp_min_size, **layout)
                     if kind == "fsdp" else None)
    return out


def param_shardings(model: nn.Module, tp: Optional[int] = None, fsdp: Optional[int] = None,
                    fsdp_min_size: int = FSDP_MIN_SIZE) -> Dict[str, str]:
    """{parameter name: `param_placement`} over a model's parameters."""
    return {name: kind for name, (kind, _) in _placements(model, tp, fsdp,
                                                          fsdp_min_size).items()}


def fsdp_dims(model: nn.Module, tp: Optional[int], fsdp: int,
              fsdp_min_size: int = FSDP_MIN_SIZE) -> Dict[str, int]:
    """{parameter name: the dim FSDP2 shards} of the "fsdp" parameters."""
    return {name: dim for name, (_, dim) in _placements(model, tp, fsdp,
                                                        fsdp_min_size).items()
            if dim is not None}


def batch_sharding(mesh, data_axis: str = "data") -> Tuple[int, int]:
    """(number of data shards, this rank's shard): its contiguous slice of
    the global batch's rows."""
    sub = mesh[data_axis]
    return sub.size(), sub.get_local_rank()


def shard_rows(x: torch.Tensor, mesh, data_axis: str = "data") -> torch.Tensor:
    """This rank's rows of a global batch (dim 0 split evenly over the data
    axis; rows must divide)."""
    n, i = batch_sharding(mesh, data_axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} data shards")
    step = x.shape[0] // n
    return x[i * step:(i + 1) * step]


def gather_rows(x: torch.Tensor, mesh, data_axis: str = "data") -> torch.Tensor:
    """The global batch from every data shard's rows (inverse of
    `shard_rows`)."""
    n, _ = batch_sharding(mesh, data_axis)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh[data_axis].get_group())
    return torch.cat(parts)


# ---------------------------------------------------------------- sharding


# ------------------------------------------------- the TP collectives


class _AllReduce(torch.autograd.Function):
    """The sum over the TP group forward; the gradient passes as it is
    (each rank's copy of the output feeds the same replicated work)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GradAllReduce(torch.autograd.Function):
    """The identity forward; the gradient summed over the TP group backward
    (each rank's split layer gives a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    buf = torch.empty((n * rows.shape[0], rows.shape[1]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(buf, rows, group=group)
    whole = buf.view(n, rows.shape[0], rows.shape[1]).permute(1, 0, 2)
    return whole.reshape(*x.shape[:-1], n * x.shape[-1])


class _AllGatherLast(torch.autograd.Function):
    """The ranks' column blocks gathered along the last dim forward; this
    rank's block of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank(ctx.group) * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if _differentiable(x):
        return _AllReduce.apply(x, group)
    dist.all_reduce(x, group=group)  # a fresh output: in place
    return x


def _grad_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _GradAllReduce.apply(x, group) if _differentiable(x) else x


def _all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    return _AllGatherLast.apply(x, group) if _differentiable(x) else _gather_last(x, group)


def _local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return t.to_local() if isinstance(t, DTensor) else t


# ------------------------------------------------------ the TP styles


class TPSplit:
    """How a module runs split over the TP group: its forward runs on the
    rank's local shards with the collectives of its `param_placement` kind
    (the Megatron pattern), so that no DTensor reaches an op: DTensor's
    dispatch of every op of an eager decode step cost ~1 s a step at
    Janus-Pro-1B width on the H100, its ops' sharding propagation being
    recomputed call by call.

      column    weight [out, in] and bias split along out (Shard(0); a
                fused output per part): the input's gradient is summed
                over the ranks; the output is this rank's columns, or all
                of them gathered (`gather`: lm_head, vision_head)
      row       weight split along in (Shard(1)), the input this rank's
                columns; the partial products summed over the ranks, the
                bias (whole on every rank) added by rank 0 (inside its
                matmul when dense), so that one rank gives the unsplit
                layer's bits; K4 takes each row's absmax over the group
      vocab     the embedding's rows split (Shard(0)); each rank looks up
                the ids it holds, zeros elsewhere, summed over the ranks

    A LoRA pair (`models/llama.py::LoRAPair`) adds its delta to a split
    projection's output: q/k/v's ("column") `a` whole, `b` this rank's
    columns, the gradient of the [.., r] intermediate x @ a summed over the
    ranks (so `a`'s gradient and the input's are whole on every rank);
    o_proj's ("row") `a` this rank's rows, the [.., r] partial products
    summed over the ranks before the whole `b` (r values a row where a
    second all-reduce of the output would move `hidden`).

    The weight-quantized modules (`ops/quant.py`) hold their rank's shard
    as plain buffers and run split the same way. `apply` sets the module's
    forward and records the split on it as `tp_split`, whose `quantized`
    `quantize_model_` calls to quantize a split layer."""

    def __init__(self, kind: str, group, gather: bool = False):
        self.kind, self.group, self.gather = kind, group, gather

    def apply(self, module: nn.Module) -> nn.Module:
        from plangen_tpu_torch.models.llama import LoRAPair

        if isinstance(module, LoRAPair):
            forward = {"column": _lora_column_forward, "row": _lora_row_forward}[self.kind]
        else:
            forward = {"column": _column_forward, "row": _row_forward,
                       "vocab": _vocab_forward}[self.kind]
        if self.kind == "row" and getattr(module, "a8", False):
            module.absmax_group = self.group
        module.forward = functools.partial(forward, module, self.group, self.gather)
        module.tp_split = self
        return module

    @torch.no_grad()
    def quantized(self, dense: List[nn.Module], quantize) -> nn.Module:
        """The quantized module of a target's split dense members (in output
        order, `ops/quant.py::_quantized`), run split: `quantize(w_io, bias,
        absmax)` of this rank's shard in the JAX layout [in, out]. A column
        split quantizes its own columns (a fused target each member's own,
        in member order); a row split its rows, each column's absmax taken
        over the whole input dim by a MAX over the group. So each rank
        holds the bytes that `shard_params` cuts out of the model quantized
        whole (`_take_shard`), and the group moves one [1, out] vector a
        row split, where gathering the weights whole would move the
        model."""
        w_io = torch.cat([_local(d.weight) for d in dense], dim=0).t()
        bias = _local(dense[0].bias) if len(dense) == 1 else None
        absmax = None
        if self.kind == "row":
            absmax = w_io.float().abs().amax(dim=-2, keepdim=True)
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=self.group)
        return self.apply(quantize(w_io, bias, absmax))


class _Split(ParallelStyle):
    """One module's `TPSplit` as a `ParallelStyle`: the parameters named in
    `placements` become DTensors placed over the TP mesh (the others stay
    whole on every rank), then the split forward."""

    def __init__(self, kind: str, gather: bool = False):
        super().__init__()
        self.kind, self.gather = kind, gather
        self.placements: Dict[str, object] = {}  # parameter name -> placement

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh) -> nn.Module:
        for pname, param in list(module.named_parameters(recurse=False)):
            placement = self.placements.get(pname)
            if placement is not None:
                module.register_parameter(pname, nn.Parameter(
                    distribute_tensor(param.data, device_mesh, [placement]),
                    requires_grad=param.requires_grad))
        return TPSplit(self.kind, device_mesh.get_group(), self.gather).apply(module)


def _column_forward(mod: nn.Module, group, gather: bool, x: torch.Tensor) -> torch.Tensor:
    x = _grad_all_reduce(x, group)
    if isinstance(mod, _QuantLinear):
        y = _QuantLinear.forward(mod, x)
    else:
        y = F.linear(x, _local(mod.weight), _local(mod.bias))
    return _all_gather_last(y, group) if gather else y


def _row_forward(mod: nn.Module, group, gather: bool, x: torch.Tensor) -> torch.Tensor:
    rank0 = dist.get_rank(group) == 0
    if isinstance(mod, _QuantLinear):
        y = mod.product(x)
        return _all_reduce(mod._add_bias(y) if rank0 else y, group)
    bias = mod.bias
    if bias is not None and _differentiable(bias):
        # every rank's copy of the whole bias takes rank 0's gradient
        bias = _grad_all_reduce(bias, group)
        bias = bias if rank0 else bias * 0
    elif not rank0:
        bias = None
    return _all_reduce(F.linear(x, _local(mod.weight), bias), group)


def _vocab_forward(mod: nn.Module, group, gather: bool, ids: torch.Tensor) -> torch.Tensor:
    w = _local(mod.weight)
    local = ids - dist.get_rank(group) * w.shape[0]
    mine = (local >= 0) & (local < w.shape[0])
    rows = F.embedding(local.clamp(0, w.shape[0] - 1), w)
    return _all_reduce(torch.where(mine[..., None], rows, torch.zeros_like(rows)), group)


def _lora_column_forward(mod: nn.Module, group, gather: bool, x: torch.Tensor,
                         scaling: torch.Tensor) -> torch.Tensor:
    return (_grad_all_reduce(x @ _local(mod.a), group) @ _local(mod.b)) * scaling


def _lora_row_forward(mod: nn.Module, group, gather: bool, x: torch.Tensor,
                      scaling: torch.Tensor) -> torch.Tensor:
    return (_all_reduce(x @ _local(mod.a), group) @ _local(mod.b)) * scaling


def _tp_styles(model: nn.Module, tp: int) -> Dict[str, ParallelStyle]:
    """{module name: style} for the modules `param_placement` splits."""
    plan: Dict[str, _Split] = {}
    whole = whole_attention(model.cfg, tp)
    for name, p in model.named_parameters():
        rule = _tp_rule(name, tuple(p.shape), tp, whole=whole)
        if rule is None:
            continue
        kind, dim = rule
        mod, pname = name.rsplit(".", 1)
        style = plan.setdefault(mod, _Split(kind, gather=mod in _GATHERED))
        parts = _parts(mod)
        style.placements[pname] = (_StridedShard(dim, split_factor=parts) if parts > 1
                                   else Shard(dim))
    return plan


@torch.no_grad()
def _take_shard(mod: nn.Module, kind: str, parts: int, rank: int, tp: int) -> None:
    """Keep this rank's shard of a quantized module's buffers (`ops/quant.py`
    layout, [in, out]): a row split its rows of the weight, the scales
    whole; a column split its block of each part's columns. The int4 form
    packs its outputs in halves (packed column j holds outputs j and j +
    O/2), so the rank's columns are unpacked, taken and packed again in
    their own halves: nibbles and scales are per column, so nothing is
    lost, and the bytes are those `TPSplit.quantized` gives the rank's
    dense shard."""
    if kind == "row":
        n = mod.in_features // tp
        for name in ("w_q8", "w_p4"):
            if hasattr(mod, name):
                setattr(mod, name, getattr(mod, name)[rank * n:(rank + 1) * n].contiguous())
        mod.in_features = n
        return
    width = mod.out_features // parts
    n = width // tp
    dev = mod.bias.device if mod.bias is not None else next(mod.buffers()).device
    cols = torch.cat([torch.arange(k * width + rank * n, k * width + (rank + 1) * n, device=dev)
                      for k in range(parts)])
    if isinstance(mod, Int8Linear):
        mod.w_q8, mod.scale = mod.w_q8[:, cols].contiguous(), mod.scale[:, cols].contiguous()
    else:
        if (n * parts) % 2:
            raise ValueError(f"int4 packing needs an even local out dim, got {n * parts}")
        q4, scale = unpack_int4({"w_p4": mod.w_p4, "s_lo": mod.s_lo, "s_hi16": mod.s_hi16})
        packed = pack_int4(q4[:, cols], scale[:, cols])
        mod.w_p4, mod.s_lo, mod.s_hi16 = packed["w_p4"], packed["s_lo"], packed["s_hi16"]
    if mod.bias is not None:
        mod.bias = mod.bias[cols].contiguous()
    mod.out_features = n * parts


def _shard_quantized(model: nn.Module, tp_mesh: DeviceMesh) -> None:
    """Split every quantized module (buffers, not parameters) that a TP
    rule names: each rank keeps its shard as plain tensors, run by the
    module's `TPSplit`; one whose dim does not divide stays whole."""
    tp, rank, group = tp_mesh.size(), tp_mesh.get_local_rank(), tp_mesh.get_group()
    whole = whole_attention(model.cfg, tp)
    for name, mod in model.named_modules():
        if not isinstance(mod, _QuantLinear):
            continue
        parts = _parts(name)
        rule = _tp_rule(name + ".weight", (mod.out_features, mod.in_features), tp, parts,
                        whole)
        if rule is None:
            continue
        _take_shard(mod, rule[0], parts, rank, tp)
        TPSplit(rule[0], group, name in _GATHERED).apply(mod)


def shard_params(model: nn.Module, mesh, tp_axis: Optional[str] = "model",
                 fsdp_axis: Optional[str] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 fsdp_min_size: int = FSDP_MIN_SIZE) -> nn.Module:
    """Place a `PlanGenModel` on the mesh, in place, as `param_placement`
    says: TP styles over `tp_axis` (any size; None: no TP; a quantized
    model's quantized modules split as `_shard_quantized` says), then FSDP2
    over `fsdp_axis` (None: no FSDP) of the "fsdp" parameters, each along
    its `fsdp_dim` (of `fsdp_min_size`), with `param_dtype` the compute
    dtype the masters are cast to after each all-gather (None: the masters'
    own). Returns the model."""
    tp = None if tp_axis is None else mesh[tp_axis].size()
    dims = {} if fsdp_axis is None else fsdp_dims(model, tp, mesh[fsdp_axis].size(),
                                                   fsdp_min_size)
    if tp_axis is not None:
        parallelize_module(model, mesh[tp_axis], _tp_styles(model, tp))
        _shard_quantized(model, mesh[tp_axis])
    if fsdp_axis is not None:
        policy = MixedPrecisionPolicy(param_dtype=param_dtype, reduce_dtype=torch.float32,
                                      cast_forward_inputs=False)
        units = list(model.language_model.model.layers)
        units += list(model.vision_model.vision_tower.blocks)
        # FSDP2 manages the "fsdp" parameters only: the TP-split ones keep
        # their TP placement alone and the replicated ones (0-d included,
        # which FSDP2 does not take) stay plain tensors, as in JAX
        shard = {id(p): Shard(dims[n]) for n, p in model.named_parameters() if n in dims}
        ignored = {p for p in model.parameters() if id(p) not in shard}
        ignored_ids = {id(p) for p in ignored}
        for unit in units + [model]:
            fully_shard(unit, mesh=mesh[fsdp_axis], mp_policy=policy, ignored_params=ignored,
                        shard_placement_fn=lambda p: shard[id(p)])
            # a plain sum (the losses divide by the global count), by SUM
            # collectives, which gloo has too
            unit.set_gradient_divide_factor(1.0)
            unit.set_force_sum_reduction_for_comms(True)
            unit.fsdp_ignored = frozenset(n for n, p in unit.named_parameters()
                                          if id(p) in ignored_ids)
    return model


def fsdp_ignored(module: nn.Module) -> FrozenSet[str]:
    """The names (relative to `module`) of the parameters that FSDP2 does
    not manage in a model `shard_params` placed with FSDP, or in one of its
    units (the TP-split ones and the replicated ones): whole over the data
    axis, so the train step casts them to the compute dtype and sums their
    gradients over the data group. Empty without FSDP."""
    return getattr(module, "fsdp_ignored", frozenset())


def split_dim(placement) -> Optional[int]:
    """The tensor dim a DTensor placement splits (`Shard`, or the per-part
    `_StridedShard`, which not every torch counts as a `Shard`), else
    None."""
    return placement.dim if isinstance(placement, (Shard, _StridedShard)) else None


def _chunk_sizes(extent: int, n: int) -> List[int]:
    """The sizes of `torch.chunk(extent, n)`'s pieces, empty ones included:
    how a `Shard` placement splits a dim over n ranks."""
    size = -(-extent // n)
    return [max(0, min(size, extent - i * size)) for i in range(n)]


def _pieces(placement, extent: int, n: int) -> Tuple[int, List[int]]:
    """(parts, the size of each rank's piece of one part) of a dim of
    `extent` that `placement` splits over n ranks: a per-part split
    (`_StridedShard`) cuts each of its parts apart."""
    parts = placement.split_factor if isinstance(placement, _StridedShard) else 1
    return parts, _chunk_sizes(extent // parts, n)


def _mesh_dim(t: DTensor):
    """(the placement, its 1-D mesh) of a DTensor `shard_params` made: each
    lies over one mesh dim, "model" (TP) or "data" (FSDP2)."""
    if t.device_mesh.ndim != 1:
        raise ValueError(f"a DTensor over {t.device_mesh.ndim} mesh dims: shard_params "
                         "places each over one")
    return t.placements[0], t.device_mesh


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """`t` whole on every rank: a DTensor gathered (a collective: every rank
    of its mesh calls it), a plain tensor as it is. The gather is c10d's
    `all_gather`, a per-part split (`_StridedShard`: SigLIP's fused qkv,
    each rank holding its block of every part) part by part, an uneven
    `Shard` padded to its first piece: DTensor's own `full_tensor`
    (functional collectives) crashed over gloo with CUDA tensors (torch
    2.11, four ranks on one card), and not every torch's takes the per-part
    placement."""
    if not isinstance(t, DTensor):
        return t
    (placement, mesh), local = _mesh_dim(t), t.to_local()
    dim = split_dim(placement)
    if dim is None:
        return local
    parts, sizes = _pieces(placement, t.shape[dim], mesh.size())
    pad = [0, 0] * (local.dim() - dim - 1) + [0, parts * sizes[0] - local.shape[dim]]
    padded = F.pad(local, pad).contiguous()
    gathered = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(gathered, padded, group=mesh.get_group())
    blocks = [g.narrow(dim, 0, parts * n).chunk(parts, dim) for g, n in zip(gathered, sizes)]
    return torch.cat([b[k] for k in range(parts) for b in blocks], dim)


def distribute_like(whole: torch.Tensor, like: DTensor) -> DTensor:
    """`whole` (the same on every rank) placed as the DTensor `like` is
    (the inverse of `full_tensor`): each rank cuts its own shard, a
    per-part split part by part, with no collective."""
    (placement, mesh), local = _mesh_dim(like), whole.to(like.device, like.dtype)
    dim = split_dim(placement)
    if dim is not None:
        parts, sizes = _pieces(placement, local.shape[dim], mesh.size())
        rank = mesh.get_local_rank()
        start = sum(sizes[:rank])
        local = torch.cat([part.narrow(dim, start, sizes[rank])
                           for part in local.chunk(parts, dim)], dim)
    return DTensor.from_local(local.contiguous(), mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def is_sharded(model: nn.Module) -> bool:
    """Whether any parameter of the model is a DTensor (TP or FSDP)."""
    return any(isinstance(p, DTensor) for p in model.parameters())
