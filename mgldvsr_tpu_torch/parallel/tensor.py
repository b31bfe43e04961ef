"""Tensor parallelism for training: Megatron's column split, each output
gathered at once.

Counterpart of the JAX package's ``tensor`` mesh axis (``_param_spec`` in
``mgldvsr_tpu/parallel/mesh.py``, :func:`~mgldvsr_tpu_torch.parallel.mesh.tensor_spec`
here), under which XLA propagates the activation shardings. A split
``Conv1d``/``Conv2d``/``Conv3d``/``Linear`` holds rows ``[t·O/T, (t+1)·O/T)``
of its weight (torch's output axis 0; the flax kernel keeps it last) as a
parameter of its own, computes those output channels, and all-gathers them
over its tensor group (:func:`gather_columns`), so every module downstream
sees the whole activation, the same on every rank of the group. Its input
passes :func:`copy_to_group`, the identity forward and the sum over the
group backward: each rank's rows of the weight give a part of the input's
gradient, and those parts are summed in float32 and rounded once. The
gather's backward takes the rank's slice of the gradient, which is the same
on every rank, with no collective. Biases stay whole, as JAX keeps 1-D
leaves; each rank adds its rows of the bias inside its conv or linear,
before the gather, so that each output channel is rounded as in one
process, and the bias passes :func:`copy_to_group` with the input, so that
its gradient (each rank's rows, zeros elsewhere) is whole on every rank.
Attention heads are never split: the gathered q, k and v reach the kernel
with all their heads.

:func:`shard_module` swaps each layer a rule splits for its column-parallel
form in place: the module path and the parameter names stay, so state-dict
keys, ``functional_call`` and the trainers' names are unchanged.
:func:`gather_module_state` rebuilds a whole state dict from the ranks'
slices. A module that uses a split weight itself (not through a
``Linear``) names it in ``column_parallel`` and calls
:func:`linear_columns`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.parallel import mesh


class _CopyToGroup(torch.autograd.Function):
    """The identity forward; the backward sums each gradient over the
    group (Megatron's ``f``) in float32, each rounded back to its dtype
    once."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return xs

    @staticmethod
    def backward(ctx, *grads):
        live = [i for i, g in enumerate(grads) if g is not None]
        summed = mesh.sum_over([grads[i].float() for i in live], ctx.group)
        out = list(grads)
        for i, g in zip(live, summed):
            out[i] = g.to(grads[i].dtype)
        if copy_to_group.shapes is not None:
            copy_to_group.shapes += [(tuple(g.shape), g.dtype) for g in summed]
        return (None, *out)


def copy_to_group(grid: mesh.Grid, *xs: torch.Tensor):
    """``xs`` as they are; in the backward each one's gradient is summed
    over ``grid``'s tensor group. One tensor in, one out; several, a
    tuple."""
    out = _CopyToGroup.apply(grid.tensor_group, *xs)
    return out[0] if len(xs) == 1 else out


copy_to_group.shapes = None  # a list to record each summed gradient's (shape, dtype) in


def copy_with_bias_rows(grid: mesh.Grid, x: torch.Tensor, bias: Optional[torch.Tensor],
                        rows: int, dtype: torch.dtype):
    """``x`` through :func:`copy_to_group`, and this rank's ``rows`` rows
    of the whole ``bias`` in ``dtype`` (None for None). A bias that needs a
    gradient passes :func:`copy_to_group` too, so its gradient, each rank's
    rows and zeros elsewhere, is summed to the whole one on every rank."""
    if bias is None:
        return copy_to_group(grid, x), None
    if bias.requires_grad:
        x, bias = copy_to_group(grid, x, bias)
    else:
        x = copy_to_group(grid, x)
    return x, bias.narrow(0, grid.tensor_index * rows, rows).to(dtype)


class _GatherColumns(torch.autograd.Function):
    """Every rank's slice along ``dim``, in rank order (Megatron's ``g``);
    the backward takes this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, world):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        x = x.contiguous()
        parts = x.new_empty(world * x.numel())
        dist.all_gather_into_tensor(parts, x.view(-1), group=group)
        parts = parts.view(world, *x.shape)
        if gather_columns.shapes is not None:
            gather_columns.shapes.append((tuple(x.shape), x.dtype))
        return parts.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, None


def gather_columns(x: torch.Tensor, dim: int, grid: mesh.Grid) -> torch.Tensor:
    """The whole activation from every rank of ``grid``'s tensor group
    holding its slice of axis ``dim`` of ``x``: one all-gather into
    ``[T, ...]`` and one copy that moves T next to ``dim``."""
    return _GatherColumns.apply(x, dim % x.ndim, grid.tensor_group, grid.tensor_index, grid.tp)


gather_columns.shapes = None  # a list to record each gather's (slice shape, dtype) in


def linear_columns(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   grid: Optional[mesh.Grid]) -> torch.Tensor:
    """``F.linear`` in ``weight``'s dtype. With ``grid``, ``weight`` holds
    this rank's rows of the whole weight and ``bias`` is whole: the whole
    output on every rank of the tensor group."""
    x = x.to(weight.dtype)
    if grid is None:
        return F.linear(x, weight, None if bias is None else bias.to(weight.dtype))
    x, bias = copy_with_bias_rows(grid, x, bias, weight.shape[0], weight.dtype)
    return gather_columns(F.linear(x, weight, bias), -1, grid)


class ColumnParallel:
    """The column-parallel form of a layer (mixed in before its class by
    :func:`shard_module`): ``weight`` holds this rank's rows, ``bias`` is
    whole (the layer adds its rows), ``tensor_parallel`` is the grid."""
    tensor_parallel: Optional[mesh.Grid] = None


class _ColumnConv(ColumnParallel):
    def forward(self, x):
        w, grid = self.weight, self.tensor_parallel
        x, bias = copy_with_bias_rows(grid, x.to(w.dtype), self.bias, w.shape[0], w.dtype)
        return gather_columns(self._conv_forward(x, w, bias), 1, grid)


class _ColumnLinear(ColumnParallel):
    def forward(self, x):
        return linear_columns(x, self.weight, self.bias, self.tensor_parallel)


_LAYERS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)
_FORMS: Dict[type, type] = {}


def _column_form(cls: type) -> type:
    if cls not in _FORMS:
        mixin = _ColumnLinear if issubclass(cls, nn.Linear) else _ColumnConv
        _FORMS[cls] = type(f"ColumnParallel{cls.__name__}", (mixin, cls), {})
    return _FORMS[cls]


def shard_module(module: nn.Module, axes: Dict[str, int], grid: mesh.Grid) -> None:
    """Split ``module`` in place over ``grid``'s tensor group: each
    parameter named in ``axes`` (``name -> axis``, from
    :func:`~mgldvsr_tpu_torch.parallel.mesh.tensor_axes`) becomes a fresh
    contiguous copy of this rank's rows (a view would keep the whole tensor
    alive), and its layer the column-parallel form. Only output axes (0) of
    conv and linear weights, and the weights a module lists in
    ``column_parallel``, can be split; anything else raises."""
    if grid.tp == 1 or not axes:
        return
    todo = dict(axes)
    for path, m in module.named_modules():
        prefix = f"{path}." if path else ""
        names = [n for n, _ in m.named_parameters(recurse=False) if prefix + n in todo]
        if not names:
            continue
        if getattr(m, "tensor_parallel", None) is not None:
            raise ValueError(f"shard_module: {path or 'the module'} is split already")
        for n in names:
            if todo.pop(prefix + n) != 0:
                raise ValueError(f"shard_module: {prefix}{n} would be split off its output axis")
        refused = getattr(m, "tensor_parallel_refused", None)
        if refused:
            raise ValueError(f"shard_module: {type(m).__name__} at {path!r}: {refused}")
        if isinstance(m, _LAYERS) and names == ["weight"]:
            m.__class__ = _column_form(type(m))
        elif not set(names) <= set(getattr(m, "column_parallel", ())):
            raise ValueError(f"shard_module: {type(m).__name__} at {path!r} cannot split "
                             f"{names}")
        for n in names:
            p = getattr(m, n)
            if p.shape[0] % grid.tp:
                raise ValueError(f"shard_module: {prefix}{n} {tuple(p.shape)} does not divide "
                                 f"over {grid.tp} ranks")
            rows = p.shape[0] // grid.tp
            part = p.detach().narrow(0, grid.tensor_index * rows, rows).clone()
            setattr(m, n, nn.Parameter(part, requires_grad=p.requires_grad))
        m.tensor_parallel = grid
        m.tensor_split = tuple(names)
    if todo:
        raise KeyError(f"shard_module: no parameter {sorted(todo)[:5]}")


def split_parameters(module: nn.Module) -> List[str]:
    """The names of ``module``'s parameters that hold a rank's rows."""
    out = []
    for path, m in module.named_modules():
        prefix = f"{path}." if path else ""
        out += [prefix + n for n in getattr(m, "tensor_split", ())]
    return out


def gather_module_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state dict with every split parameter whole (detached).
    Collective over the tensor group where anything is split: every rank of
    the group calls it."""
    sd = {k: v.detach() for k, v in module.state_dict().items()}
    split = split_parameters(module)
    if not split:
        return sd
    grid = next(m.tensor_parallel for m in module.modules()
                if getattr(m, "tensor_split", None))
    whole = mesh.AxisSplit({k: 0 for k in split}, grid.tensor_group).gather(
        {k: sd[k] for k in split})
    sd.update(whole)
    return sd
