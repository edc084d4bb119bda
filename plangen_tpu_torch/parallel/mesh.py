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
  * FSDP over "data" is FSDP2 (`fully_shard`): one unit per LLaMA layer
    and SigLIP block, the rest in the root. FSDP2 shards every parameter
    of a unit, so the port shards every tensor JAX does (those of
    `fsdp_min_size` elements or more) and the small ones too; which dim it
    splits does not change the numbers. `MixedPrecisionPolicy` casts the
    masters to the compute dtype after the all-gather and reduces the
    gradients in fp32, summed over the data group (the losses divide by
    the global token count, `train/loss.py`).
  * The batch: each data shard of the mesh takes its contiguous slice of
    the global batch's rows (`batch_sharding`, `shard_rows`); ranks that
    differ only in their "model" coordinate take the same rows.

`param_placement` is the pure rule (name, shape, tp size, fsdp size) that
`shard_params` applies, so a test can hold it against JAX's
`param_shardings` without processes. Not done, and raising
`NotImplementedError`: LoRA adapters and the weight-quantized forms under
TP, a head count that does not split over the TP axis.
"""

from __future__ import annotations

import datetime
import functools
import os
import re
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ParallelStyle, parallelize_module
from torch.distributed.tensor.placement_types import _StridedShard

AXES = ("data", "model")
KINDS = ("vocab", "column", "row", "fsdp", "replicated")

# parameter-name pattern -> the TP kind of its module (JAX's `_TP_RULES`)
_BLOCKS = r"^vision_model\.vision_tower\.blocks\.\d+\."
_TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"^language_model\.model\.embed_tokens\.weight$", "vocab"),
    (r"^language_model\.lm_head\.weight$", "column"),
    (r"\.self_attn\.(q_proj|k_proj|v_proj)\.weight$", "column"),
    (r"\.self_attn\.o_proj\.weight$", "row"),
    (r"\.mlp\.(gate_proj|up_proj)\.weight$", "column"),
    (r"\.mlp\.down_proj\.weight$", "row"),
    (_BLOCKS + r"(attn\.qkv|mlp\.fc1)\.(weight|bias)$", "column"),
    (_BLOCKS + r"(attn\.proj|mlp\.fc2)\.weight$", "row"),
    (r"^gen_head\.vision_head\.(weight|bias)$", "column"),
)
_GATHERED = ("language_model.lm_head", "gen_head.vision_head")  # logits, whole


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


def param_placement(name: str, shape: Sequence[int], tp: Optional[int] = None,
                    fsdp: Optional[int] = None) -> str:
    """How `shard_params` places one parameter: "vocab", "column", "row"
    (TP over an axis of size `tp`), "fsdp" (FSDP2 over an axis of size
    `fsdp`) or "replicated". None leaves an axis out. A TP rule whose split
    dim does not divide by `tp` leaves the tensor replicated, as in JAX;
    under FSDP every parameter that no TP rule splits is sharded. (At size
    1 a split tensor is whole on its one rank, as JAX's replicated one.)"""
    if tp is not None:
        for pattern, kind in _TP_RULES:
            if re.search(pattern, name):
                if shape[1 if kind == "row" else 0] % tp == 0:
                    return kind
                break
    return "replicated" if fsdp is None else "fsdp"


def param_shardings(model: nn.Module, tp: Optional[int] = None,
                     fsdp: Optional[int] = None) -> Dict[str, str]:
    """{parameter name: `param_placement`} over a model's parameters."""
    return {name: param_placement(name, tuple(p.shape), tp, fsdp)
            for name, p in model.named_parameters()}


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


class _Split(ParallelStyle):
    """One TP kind of `param_placement` as a `ParallelStyle`: the module's
    parameters become DTensors placed over the TP mesh, and its forward
    runs on each rank's local shards with explicit collectives (the
    Megatron pattern), so that no DTensor reaches an op: DTensor's
    dispatch of every op of an eager decode step cost ~1 s a step at
    Janus-Pro-1B width on the H100, its ops' sharding propagation being
    recomputed call by call.

      column    weight [out, in] and bias split along out (Shard(0); a
                fused qkv per part, `_StridedShard(0, 3)`): the input's
                gradient is summed over the ranks; the output is this
                rank's columns, or all of them gathered (`gather`:
                lm_head, vision_head)
      row       weight split along in (Shard(1)), the input this rank's
                columns; the partial products summed over the ranks, the
                bias (whole on every rank) added by rank 0 inside its
                matmul, so that one rank gives the unsplit layer's bits
      vocab     the embedding's rows split (Shard(0)); each rank looks up
                the ids it holds, zeros elsewhere, summed over the ranks
    """

    def __init__(self, kind: str, gather: bool = False, parts: int = 1):
        super().__init__()
        self.kind, self.gather, self.parts = kind, gather, parts

    def _placement(self, pname: str):
        if self.kind == "row":
            return Shard(1) if pname == "weight" else None  # the bias stays whole
        return _StridedShard(0, split_factor=self.parts) if self.parts > 1 else Shard(0)

    def _apply(self, module: nn.Module, device_mesh: DeviceMesh) -> nn.Module:
        for pname, param in list(module.named_parameters(recurse=False)):
            placement = self._placement(pname)
            if placement is not None:
                module.register_parameter(pname, nn.Parameter(
                    distribute_tensor(param.data, device_mesh, [placement]),
                    requires_grad=param.requires_grad))
        group = device_mesh.get_group()
        forward = {"column": _column_forward, "row": _row_forward,
                   "vocab": _vocab_forward}[self.kind]
        module.forward = functools.partial(forward, module, group, self.gather)
        return module


def _column_forward(mod: nn.Module, group, gather: bool, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(_grad_all_reduce(x, group), _local(mod.weight), _local(mod.bias))
    return _all_gather_last(y, group) if gather else y


def _row_forward(mod: nn.Module, group, gather: bool, x: torch.Tensor) -> torch.Tensor:
    bias = mod.bias
    if bias is not None and _differentiable(bias):
        # every rank's copy of the whole bias takes rank 0's gradient
        bias = _grad_all_reduce(bias, group)
        bias = bias if dist.get_rank(group) == 0 else bias * 0
    elif dist.get_rank(group) != 0:
        bias = None
    return _all_reduce(F.linear(x, _local(mod.weight), bias), group)


def _vocab_forward(mod: nn.Module, group, gather: bool, ids: torch.Tensor) -> torch.Tensor:
    w = _local(mod.weight)
    local = ids - dist.get_rank(group) * w.shape[0]
    mine = (local >= 0) & (local < w.shape[0])
    rows = F.embedding(local.clamp(0, w.shape[0] - 1), w)
    return _all_reduce(torch.where(mine[..., None], rows, torch.zeros_like(rows)), group)


def _tp_styles(model: nn.Module, tp: int) -> Dict[str, ParallelStyle]:
    """{module name: style} for the modules `param_placement` splits."""
    plan = {}
    for name, p in model.named_parameters():
        kind = param_placement(name, tuple(p.shape), tp)
        mod = name.rsplit(".", 1)[0]
        if kind in ("replicated", "fsdp") or mod in plan:
            continue
        plan[mod] = _Split(kind, gather=mod in _GATHERED,
                           parts=3 if mod.endswith("attn.qkv") else 1)
    return plan


def _check_tp(model: nn.Module, tp: int) -> None:
    from plangen_tpu_torch.ops.quant import quant_form

    if quant_form(model) is not None:
        raise NotImplementedError(
            f"the {quant_form(model)} weight-quantized form under tensor parallelism")
    if any(".lora." in name for name, _ in model.named_parameters()):
        raise NotImplementedError("LoRA adapters under tensor parallelism (model > 1)")
    llama, vision = model.cfg.llama, model.cfg.vision
    for what, heads, dim in (("LLaMA", llama.num_heads, llama.q_dim),
                             ("LLaMA KV", llama.num_kv_heads, llama.kv_dim),
                             ("SigLIP", vision.heads, 3 * vision.width)):
        if dim % tp == 0 and heads % tp:
            raise NotImplementedError(
                f"{what} heads {heads} do not split over a TP axis of {tp}")


def shard_params(model: nn.Module, mesh, tp_axis: Optional[str] = "model",
                 fsdp_axis: Optional[str] = None,
                 param_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Place a `PlanGenModel` on the mesh, in place, as `param_placement`
    says: TP styles over `tp_axis` (any size; None: no TP), then FSDP2 over
    `fsdp_axis` (None: no FSDP), with `param_dtype` the compute dtype the
    masters are cast to after each all-gather (None: the masters' own).
    Returns the model."""
    if tp_axis is not None:
        tp = mesh[tp_axis].size()
        _check_tp(model, tp)
        parallelize_module(model, mesh[tp_axis], _tp_styles(model, tp))
    if fsdp_axis is not None:
        policy = MixedPrecisionPolicy(param_dtype=param_dtype, reduce_dtype=torch.float32,
                                      cast_forward_inputs=False)
        units = list(model.language_model.model.layers)
        units += list(model.vision_model.vision_tower.blocks)
        for unit in units + [model]:
            fully_shard(unit, mesh=mesh[fsdp_axis], mp_policy=policy)
            # a plain sum (the losses divide by the global count), by SUM
            # collectives, which gloo has too
            unit.set_gradient_divide_factor(1.0)
            unit.set_force_sum_reduction_for_comms(True)
    return model


def is_sharded(model: nn.Module) -> bool:
    """Whether any parameter of the model is a DTensor (TP or FSDP)."""
    return any(isinstance(p, DTensor) for p in model.parameters())
