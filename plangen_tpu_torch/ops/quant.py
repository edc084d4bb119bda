"""Weight quantization of the serving path: int8 and packed int4 modules.

Port of `plangen_tpu/ops/quant.py`. The JAX package swaps parameter leaves
for dicts that `qmatmul` dispatches on; the port swaps `nn.Linear` modules
for modules that hold the same arrays, in the JAX layout ([in, out], not
`nn.Linear`'s [out, in]), as buffers:

  * `Int8Linear`: `w_q8` int8 [in, out] and `scale` fp32 [1, out];
    `x @ w_q8.to(x.dtype)`, then the fp32 scale, then the cast back, in
    plain torch (the JAX package leaves it to XLA).
  * `Int4Linear`: `w_p4` int8 [in, out/2], `s_lo` / `s_hi16` fp32
    [1, out/2] (see `ops/int4_matmul.py`), and the `a8` choice of the W4A8
    kernel; its forward is `int4_matmul_2d`.

Both may carry a dense `bias`, added after the quantized product in
x.dtype (`gen_head.fc2`: `qmatmul(x, w) + b`).

`quantize_model_(model, mode)` replaces the decode-dominant matmuls in
place: every LLaMA projection, `lm_head` and `gen_head.vision_head` (fc2).
Norms, embeddings, `gen_head.output_mlp_projector` (fc1), the aligners and
the VQ decoder stay dense. The int4 forms fuse same-input projections as
`INT4_FUSED_GROUPS` does (`qkv_proj`, or `k_v_proj` under GQA, and
`gate_up_proj`); int8 keeps them split, as `quantize_lm_params` does.

`int4_view(model)` is the dual-resident form of `quantize="auto"` (the
counterpart of `quantize_lm_params_int4_shared`): a second model whose
int4 targets are `Int4Linear` modules and whose every other module is the
dense model's own object, so only the packed weights cost memory.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from plangen_tpu_torch.ops import scale_of
from plangen_tpu_torch.ops.int4_matmul import int4_matmul_2d, quantize_weight_int4

QuantWeight = Dict[str, torch.Tensor]

MODES = ("int8", "int8_kv", "int4", "int4_a8")  # GenerationConfig.quantize
LM_QUANT_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")
INT4_FUSED_GROUPS = (
    ("q_proj", "k_proj", "v_proj", "qkv_proj"),
    ("k_proj", "v_proj", "k_v_proj"),  # GQA fallback
    ("gate_proj", "up_proj", "gate_up_proj"),
)
_ATTN_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj", "k_v_proj")


def quantize_weight(w: torch.Tensor, absmax: Optional[torch.Tensor] = None) -> QuantWeight:
    """Symmetric per-output-channel int8 quantization of [..., in, out];
    `absmax` [..., 1, out] replaces the columns' absmax over `in` (a
    row-parallel shard passes the whole input dim's). The scale is absmax /
    127: the JAX package quantizes int8 weights eagerly, in its pipeline
    and in `cli convert` alike."""
    wf = w.float()
    if absmax is None:
        absmax = wf.abs().amax(dim=-2, keepdim=True)  # [..., 1, out]
    scale = torch.where(absmax > 0, scale_of(absmax, 127.0, jitted=False),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w_q8": q, "scale": scale}


def dequantize_weight(q: QuantWeight, dtype=torch.bfloat16) -> torch.Tensor:
    return (q["w_q8"].float() * q["scale"]).to(dtype)


class _QuantLinear(nn.Module):
    """`forward(x)` is `product(x)` (the quantized matmul, in x.dtype) plus
    the bias; a row-parallel shard (`parallel/mesh.py`) adds the bias on
    one rank only."""

    bias: Optional[torch.Tensor]

    def _init_bias(self, bias: Optional[torch.Tensor]) -> None:
        self.register_buffer("bias", None if bias is None else bias.detach().clone())

    def _add_bias(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.bias is None else out + self.bias

    def product(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._add_bias(self.product(x))


class Int8Linear(_QuantLinear):
    """y = x @ dequant(w_q8, scale) (+ bias), int8 per-channel weights."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_q8", torch.zeros(
            (in_features, out_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            (1, out_features), dtype=torch.float32, device=device))
        self._init_bias(torch.zeros(out_features, dtype=dtype, device=device)
                        if bias else None)

    @classmethod
    def from_dense(cls, w_io: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   absmax: Optional[torch.Tensor] = None):
        """From a dense weight in the JAX layout [in, out] (`absmax`: as
        `quantize_weight`'s)."""
        mod = cls(*w_io.shape, device=w_io.device)
        q = quantize_weight(w_io, absmax)
        mod.w_q8.copy_(q["w_q8"])
        mod.scale.copy_(q["scale"])
        mod._init_bias(bias)
        return mod

    def product(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.w_q8.to(x.dtype)
        # the per-channel scale in fp32, as qmatmul does
        return (out.float() * self.scale[0]).to(x.dtype)


class Int4Linear(_QuantLinear):
    """y = x @ the packed int4 weight (+ bias), through `int4_matmul_2d`:
    K2 (W4A16), or K4 (W4A8) when `a8`, at <= 256 rows; K4 takes each row's
    absmax over `absmax_group` when set (a row-parallel shard)."""

    absmax_group = None

    def __init__(self, in_features: int, out_features: int, a8: bool = False,
                 bias: bool = False, device=None, dtype=None):
        super().__init__()
        if out_features % 2:
            raise ValueError(f"int4 packing needs an even out dim, got {out_features}")
        self.in_features, self.out_features, self.a8 = in_features, out_features, a8
        half = out_features // 2
        self.register_buffer("w_p4", torch.full(
            (in_features, half), 8, dtype=torch.int8, device=device))
        self.register_buffer("s_lo", torch.ones((1, half), dtype=torch.float32, device=device))
        self.register_buffer("s_hi16", torch.ones((1, half), dtype=torch.float32, device=device))
        self._init_bias(torch.zeros(out_features, dtype=dtype, device=device)
                        if bias else None)

    @classmethod
    def from_dense(cls, w_io: torch.Tensor, a8: bool = False,
                   bias: Optional[torch.Tensor] = None, absmax: Optional[torch.Tensor] = None,
                   eager: bool = False):
        """From a dense weight in the JAX layout [in, out] (`absmax`,
        `eager`: as `quantize_weight_int4`'s)."""
        mod = cls(*w_io.shape, a8=a8, device=w_io.device)
        q = quantize_weight_int4(w_io, absmax=absmax, eager=eager)
        for name in ("w_p4", "s_lo", "s_hi16"):
            getattr(mod, name).copy_(q[name])
        mod._init_bias(bias)
        return mod

    def product(self, x: torch.Tensor) -> torch.Tensor:
        return int4_matmul_2d(x, self.w_p4, self.s_lo, self.s_hi16, a8=self.a8,
                              absmax_group=self.absmax_group)


# ------------------------------------------------------------- model surgery


def fuse_plan(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, Tuple[str, ...]]:
    """fused key -> its member keys, unfused keys -> themselves: the first
    group of INT4_FUSED_GROUPS whose members are all present, unconsumed
    and of one shape wins (`_fuse_plan` of the JAX package)."""
    plan, consumed = {}, set()
    for grp in INT4_FUSED_GROUPS:
        members, fk = grp[:-1], grp[-1]
        if any(m in consumed or m not in shapes for m in members):
            continue
        if len({shapes[m] for m in members}) == 1:
            plan[fk] = members
            consumed.update(members)
    for k in LM_QUANT_KEYS:
        if k not in consumed:
            plan[k] = (k,)
    return plan


def _layer_linears(layer: nn.Module) -> Dict[str, nn.Module]:
    sa, mlp = layer.self_attn, layer.mlp
    return {k: getattr(sa if k in _ATTN_KEYS else mlp, k) for k in LM_QUANT_KEYS}


def _parent(layer: nn.Module, key: str) -> nn.Module:
    return layer.self_attn if key in _ATTN_KEYS else layer.mlp


def targets(model: nn.Module, mode: str) -> List[Tuple[nn.Module, str, Tuple]]:
    """(parent module, new name, sources) for every matmul that `mode`
    quantizes. A source is (parent, name) of a dense `nn.Linear`; a fused
    target lists its members in output order."""
    lm = model.language_model
    out = []
    for layer in lm.model.layers:
        linears = _layer_linears(layer)
        if mode == "int8":
            plan = {k: (k,) for k in LM_QUANT_KEYS}
        else:
            plan = fuse_plan({k: tuple(m.weight.shape) for k, m in linears.items()})
        for fk, members in plan.items():
            out.append((_parent(layer, fk), fk,
                        tuple((_parent(layer, m), m) for m in members)))
    out.append((lm, "lm_head", ((lm, "lm_head"),)))
    head = model.gen_head
    out.append((head, "vision_head", ((head, "vision_head"),)))
    return out


def quant_form(model: nn.Module) -> Optional[str]:
    """'int8', 'int4' or 'int4_a8' when the model's LM matmuls are
    quantized, None when they are dense (`_artifact_quant_form`)."""
    sa = model.language_model.model.layers[0].self_attn
    q = getattr(sa, "qkv_proj", None) or sa.q_proj
    if isinstance(q, Int8Linear):
        return "int8"
    if isinstance(q, Int4Linear):
        return "int4_a8" if q.a8 else "int4"
    return None


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"quantize must be one of {MODES}, got {mode!r}")


@torch.no_grad()
def quantized_structure_(model: nn.Module, mode: str) -> nn.Module:
    """Replace the dense matmuls that `mode` quantizes by quantized modules
    of the same shapes with placeholder contents (for loading a quantized
    tree); the dense weights are freed."""
    _check_mode(mode)
    if mode == "int8_kv":
        return model
    for parent, name, sources in targets(model, mode):
        dense = [getattr(p, m) for p, m in sources]
        kw = dict(device=dense[0].weight.device, dtype=dense[0].weight.dtype,
                  bias=dense[0].bias is not None)
        in_f = dense[0].in_features
        out_f = sum(d.out_features for d in dense)
        mod = (Int8Linear(in_f, out_f, **kw) if mode == "int8"
               else Int4Linear(in_f, out_f, a8=mode == "int4_a8", **kw))
        for p, m in sources:
            delattr(p, m)
        setattr(parent, name, mod)
    return model


def _quantized(dense: List[nn.Module], mode: str, eager: bool = False) -> _QuantLinear:
    """The quantized module of one target's dense members (in output
    order), in the JAX layout; `eager` as `quantize_model_`'s. Members
    split over ranks carry a `tp_split` (`parallel/mesh.py::TPSplit`), whose
    `quantized` quantizes this rank's shard with `quantize` below."""

    def quantize(w_io: torch.Tensor, bias: Optional[torch.Tensor],
                 absmax: Optional[torch.Tensor] = None) -> _QuantLinear:
        if mode == "int8":
            return Int8Linear.from_dense(w_io, bias=bias, absmax=absmax)
        return Int4Linear.from_dense(w_io, a8=mode == "int4_a8", bias=bias, absmax=absmax,
                                     eager=eager)

    split = getattr(dense[0], "tp_split", None)
    if split is not None:
        return split.quantized(dense, quantize)
    # [out, in] weights -> one [in, sum(out)] weight in the JAX layout
    w_io = torch.cat([d.weight for d in dense], dim=0).t()
    return quantize(w_io, dense[0].bias if len(dense) == 1 else None)


@torch.no_grad()
def quantize_model_(model: nn.Module, mode: str, eager: bool = False) -> nn.Module:
    """Quantize `model` in place to `mode` ('int8', 'int8_kv', 'int4',
    'int4_a8'); the dense weights are freed as each module is replaced, so
    the model never holds both forms. 'int8_kv' keeps the weights dense
    (its int8 KV cache is a decode setting). A TP-split model is quantized
    on each rank's shards (`_quantized`). int4 scales follow the JAX call
    site this one stands for: the pipeline's jitted quantization (absmax *
    fl(1/7)), or with `eager` that of `cli convert` (absmax / 7); int8
    scales divide either way, as JAX quantizes int8 eagerly. Returns
    `model`."""
    _check_mode(mode)
    if quant_form(model) is not None:
        raise ValueError(f"the model is already {quant_form(model)}-quantized")
    if mode == "int8_kv":
        return model
    for parent, name, sources in targets(model, mode):
        mod = _quantized([getattr(p, m) for p, m in sources], mode, eager)
        for p, m in sources:
            delattr(p, m)
        setattr(parent, name, mod)
    return model


def _fresh_copy(mod: nn.Module) -> nn.Module:
    """A shallow copy with its own `_modules` dict: replacing a child of the
    copy leaves `mod` as it is (`copy.copy` alone shares the dict)."""
    new = copy.copy(mod)
    new._modules = dict(mod._modules)
    return new


@torch.no_grad()
def int4_view(model: nn.Module, a8: bool = False) -> nn.Module:
    """The int4 view of a dense `model` (module docstring): every module on
    the path from the root to an int4 target is copied with its own child
    dict, the target replaced there by an `Int4Linear` quantized from the
    dense weight (on each rank's shards when the model is TP-split); every
    other module, with its parameters, is shared."""
    if quant_form(model) is not None:
        raise ValueError(f"the model is already {quant_form(model)}-quantized: "
                         "the int4 view is built from the dense model")
    names = {id(mod): name for name, mod in model.named_modules()}
    view = _fresh_copy(model)
    fresh = {"": view}

    def in_view(path: str) -> nn.Module:
        if path not in fresh:
            parent_path, _, name = path.rpartition(".")
            parent = in_view(parent_path)
            fresh[path] = parent._modules[name] = _fresh_copy(parent._modules[name])
        return fresh[path]

    mode = "int4_a8" if a8 else "int4"
    for parent, name, sources in targets(model, mode):
        mod = _quantized([getattr(p, m) for p, m in sources], mode)
        target = in_view(names[id(parent)])
        for p, m in sources:
            delattr(in_view(names[id(p)]), m)
        setattr(target, name, mod)
    return view
