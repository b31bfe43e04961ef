"""The process groups of a multi-device restore or training run: one
process per device.

Counterpart of ``mgldvsr_tpu/parallel/mesh.py``. The serving half
(``make_mesh`` and ``init_multihost``) is :func:`init_group` and
:func:`subgroup`. The trainer half lays the ranks out on JAX's
``('data', 'tensor')`` grid (:func:`init_grid`, a :class:`Grid`): rank r sits
at data index ``r // T`` and tensor index ``r % T``, as JAX's
``devices.reshape(dp, tp)``. Each data index takes one clip a micro-step
(JAX's one clip per ``data`` slot); the T ranks of a tensor group take the
same clip.

Which collectives run over which group:

- the **tensor group** (the T ranks of one data index): the column-parallel
  layers' activation all-gathers and their input gradients' all-reduces
  (:mod:`mgldvsr_tpu_torch.parallel.tensor`), the global norm's sum over
  the tensor-split leaves, and a broadcast of the whole leaves' reduced
  gradients from tensor rank 0 (each rank computes them on its own, and on
  the card two ranks need not get the same bits). The leaves the JAX rule
  splits (``_param_spec``, :func:`tensor_spec`: the output axis of kernels
  at least ``TENSOR_MIN_OUT`` wide, never norms, embeddings or logvar) are
  held as slices by every field of the state, frozen towers included;
- the **data group** (the D ranks of one tensor index): the float32
  gradients' mean (:func:`all_reduce_mean`, JAX's ``psum`` inside the
  jitted step), the metrics' means, stage 2's adaptive weight and
  discriminator statistics, and ZeRO-1 (:class:`ZeroShard`: the moments,
  the accumulator and the EMA split over the data ranks with the JAX
  package's ``_zero1_spec``, on top of the tensor split);
- the **world**: checkpoint reads and writes, the signal flags.

:func:`shard_state`, :func:`gather_state` and :func:`broadcast_state` move a
trainer's state between the whole layout of a checkpoint and the ranks'
slices. Every collective in a world of one leaves its tensors as they were,
bit for bit. Launch one process per card with
``torchrun --nproc_per_node=N``, which puts ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in each process's
environment; :func:`init_group` reads them. Without ``torchrun``, set the
three ranks yourself and pass a ``file://`` init method on a file system
every process sees.

The backend follows the device: NCCL for CUDA (rank r runs on
``cuda:{LOCAL_RANK}``), gloo for the CPU. A CUDA request where CUDA or NCCL
is missing raises; it never carries on in gloo or on the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
# leaves below this many elements stay whole on every rank under ZeRO-1 (the
# JAX package's constant; tests lower it to split the tiny models' leaves)
ZERO1_MIN_SIZE = 65536
# kernels whose output axis is narrower than this stay whole on every rank of
# a tensor group (the JAX package's ``_param_spec`` constant; tests lower it)
TENSOR_MIN_OUT = 256
# the largest flat buffer a bucketed collective allocates, in elements
BUCKET_ELEMS = 1 << 26
# each tensor's offset in a bucket is a multiple of this many elements, so
# that a view of it is as aligned as a tensor of its own (a reduction over
# the view then takes the same vectorised path and gives the same bits)
_ALIGN = 64

Tensors = Dict[str, torch.Tensor]

# subgroups of the first n ranks, by n; dist.new_group is collective, so
# every rank makes them in the same order and keeps them until destroy()
_subgroups: dict = {}


def init_group(device: torch.device | str, init_method: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group and return this rank's device.

    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (default ``RANK``) come from
    the environment; ``init_method`` defaults to ``env://`` (``torchrun``'s
    ``MASTER_ADDR`` and ``MASTER_PORT``). ``timeout`` bounds every
    collective, a barrier where other ranks are still restoring included."""
    device = torch.device(device)
    try:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(f"init_group: {e.args[0]} is not set; launch with torchrun or set "
                           f"RANK and WORLD_SIZE") from None
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_group: a CUDA device was asked for and none is available")
        if not dist.is_nccl_available():
            raise RuntimeError("init_group: a CUDA device was asked for and this PyTorch has "
                               "no NCCL")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_group: no backend for device {device}")
    dist.init_process_group(backend, init_method=init_method or "env://", timeout=timeout,
                            world_size=world, rank=rank,
                            device_id=device if backend == "nccl" else None)
    return device


def destroy() -> None:
    """Leave the process group (and forget its subgroups)."""
    _subgroups.clear()
    dist.destroy_process_group()


def rank(group=None) -> int:
    """This process's rank in ``group`` (the whole world by default)."""
    return dist.get_rank(group)


def world(group=None) -> int:
    """The number of ranks in ``group`` (the whole world by default)."""
    return dist.get_world_size(group)


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; under NCCL on this rank's card."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def subgroup(n: int):
    """The group of ranks 0..n-1. Every rank must call this with the same n
    in the same order (``dist.new_group`` is collective); ranks outside get
    a handle they must not use. The whole world is the default group."""
    if not 1 <= n <= world():
        raise ValueError(f"subgroup: {n} ranks of a world of {world()}")
    if n == world():
        return dist.group.WORLD
    if n not in _subgroups:
        _subgroups[n] = dist.new_group(list(range(n)))
    return _subgroups[n]


# ---------------------------------------------------------------------------
# the training grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on the (data x tensor) grid of a training run and
    the two groups it belongs to. ``data_group``: the ``dp`` ranks of its
    tensor index (the whole world where ``tp`` is 1); ``tensor_group``: the
    ``tp`` ranks of its data index (None where ``tp`` is 1)."""
    dp: int
    tp: int
    data_index: int
    tensor_index: int
    data_group: Any = None
    tensor_group: Any = None


def init_grid(tp: int = 1) -> Grid:
    """The world as a grid of ``world // tp`` x ``tp`` ranks, ``tp``
    degraded as JAX's ``make_mesh`` degrades it (to the largest divisor of
    the world that is at most ``tp``). Collective: every rank calls it with
    the same ``tp`` (``dist.new_group`` is collective, so every rank makes
    every group, in the same order); a group of the whole world is the
    world's."""
    n, r = world(), rank()
    tp = max(1, min(tp, n))
    while n % tp:
        tp -= 1
    dp = n // tp
    data_group = tensor_group = None
    for t in range(tp):
        g = dist.group.WORLD if dp == n else dist.new_group(list(range(t, n, tp)))
        if r % tp == t:
            data_group = g
    if tp > 1:
        for d in range(dp):
            g = dist.group.WORLD if tp == n else dist.new_group(list(range(d * tp, (d + 1) * tp)))
            if r // tp == d:
                tensor_group = g
    return Grid(dp, tp, r // tp, r % tp, data_group, tensor_group)


def tensor_spec(path: str, shape, tp: int) -> Optional[int]:
    """The JAX package's tensor rule (``_param_spec``) for the leaf at the
    JAX path ``path`` with the JAX-layout ``shape`` (the output axis last):
    the axis it splits over ``tp`` ranks, which is the last, or None. A leaf
    of at least two axes is split when its output width is at least
    ``TENSOR_MIN_OUT`` (read at call time) and ``tp`` divides it, unless its
    path names a norm, an embedding or logvar."""
    if tp <= 1 or len(shape) < 2:
        return None
    out = shape[-1]
    if out % tp or out < TENSOR_MIN_OUT:
        return None
    if any(k in path.lower() for k in ("norm", "embedding", "logvar")):
        return None
    return len(shape) - 1


def tensor_axes(tower: str, module: torch.nn.Module, tp: int) -> Dict[str, int]:
    """The parameters of ``module`` that the JAX rule splits over ``tp``
    ranks, by name, each with the torch axis it is split along. ``tower``
    names the module as the JAX state does (``unet``, ``structcond``,
    ``vae``, ``clip``, ``raft``, ``lpips``, ``spynet``, ``disc``): the rule
    reads each leaf's JAX path, which ``io.from_jax``'s key maps give."""
    if tp <= 1:
        return {}
    from mgldvsr_tpu_torch.io.from_jax import jax_paths

    paths = jax_paths(tower, module)
    out = {}
    for name, p in module.named_parameters():
        if p.ndim < 2:
            continue
        path, axis = paths[name]
        axis %= p.ndim
        shape = tuple(n for i, n in enumerate(p.shape) if i != axis) + (p.shape[axis],)
        if tensor_spec("/".join(path), shape, tp) is not None:
            out[name] = axis
    return out


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, with a gradient: the backward sums the
    cotangents over the group too (each rank's loss reaches every rank's
    input through the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def _buckets(tensors: List[torch.Tensor]):
    """Runs of ``tensors`` that share a dtype and device, each at most
    ``BUCKET_ELEMS`` elements (a longer tensor alone), with each tensor's
    aligned offset: [(members, offsets, total)]."""
    out, run, offsets, used = [], [], [], 0
    for t in tensors:
        size = -(-t.numel() // _ALIGN) * _ALIGN
        if run and (used + size > BUCKET_ELEMS or t.dtype != run[0].dtype
                    or t.device != run[0].device):
            out.append((run, offsets, used))
            run, offsets, used = [], [], 0
        run.append(t)
        offsets.append(used)
        used += size
    if run:
        out.append((run, offsets, used))
    return out


def _packed(members, offsets, total) -> torch.Tensor:
    flat = torch.zeros(total, dtype=members[0].dtype, device=members[0].device)
    for t, o in zip(members, offsets):
        flat[o:o + t.numel()].copy_(t.reshape(-1))
    return flat


def all_reduce_mean(tensors: Tensors, group=None) -> Tensors:
    """The mean over the ranks of ``group`` of each tensor, in a few flat
    buckets (one collective each, not one a tensor): the sum divided by the
    world. Returns new tensors (views into the buckets); in a world of one
    they equal the inputs bit for bit."""
    world = dist.get_world_size(group)
    keys = iter(tensors)
    out = {}
    for members, offsets, total in _buckets(list(tensors.values())):
        flat = _packed(members, offsets, total)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for t, o in zip(members, offsets):
            out[next(keys)] = flat[o:o + t.numel()].view(t.shape)
    return out


def sum_over(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each tensor summed over the ranks of ``group``, in a few flat buckets
    (one all-reduce each); new tensors, the inputs untouched."""
    out = []
    for members, offsets, total in _buckets(tensors):
        flat = _packed(members, offsets, total)
        dist.all_reduce(flat, group=group)
        out += [flat[o:o + t.numel()].view(t.shape) for t, o in zip(members, offsets)]
    return out


def zero1_spec(shape, dp: int, min_size: Optional[int] = None,
               tensor_axis: Optional[int] = None) -> Optional[int]:
    """The JAX package's ZeRO-1 rule (``_zero1_spec``) for a tensor of the
    whole ``shape`` whose axis ``tensor_axis`` (if any) the tensor rule
    splits: the largest other axis that ``dp`` divides (and that is at
    least ``dp`` long; the first of equal ones), or None where ``dp`` is 1,
    the whole tensor has fewer than ``min_size`` elements (default
    ``ZERO1_MIN_SIZE``, read at call time) or no axis qualifies. A rank's
    tensor slice is cut along this axis too: the judgment is on the whole
    tensor, as JAX's is on the global leaf."""
    min_size = ZERO1_MIN_SIZE if min_size is None else min_size
    if dp <= 1 or math.prod(shape) < min_size:
        return None
    best = None
    for i, n in enumerate(shape):
        if i != tensor_axis and n % dp == 0 and n >= dp and (best is None or n > shape[best]):
            best = i
    return best


class AxisSplit:
    """Tensors (by name) each split in ``world`` equal pieces along an axis
    of its own (``axes``) over the ranks of ``group``: rank r holds the r-th
    piece. Names not in ``axes`` are whole on every rank."""

    def __init__(self, axes: Dict[str, int], group=None):
        self.axes = dict(axes)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    # -- one tensor ----------------------------------------------------------

    def local(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``full`` (a view), or ``full`` where ``key``
        is not split."""
        axis = self.axes.get(key)
        if axis is None:
            return full
        n = full.shape[axis] // self.world
        return full.narrow(axis, self.rank * n, n)

    def locals(self, tensors: Tensors) -> Tensors:
        return {k: self.local(k, v) for k, v in tensors.items()}

    def _unflatten(self, key: str, rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Rows of slices [world, m] (or one row [m]) back to the layout of
        ``like`` (the full tensor, or a slice) along the key's axis."""
        axis = self.axes[key]
        moved = like.movedim(axis, 0).shape
        return rows.reshape(moved).movedim(0, axis)

    # -- collectives -----------------------------------------------------------

    def all_gather(self, tensors: Tensors) -> None:
        """Fill each split tensor of ``tensors`` (full size, this rank's
        slice up to date) with every rank's slice, in place."""
        split = [k for k in tensors if k in self.axes]
        for members, _, _ in _buckets([tensors[k] for k in split]):
            keys, split = split[:len(members)], split[len(members):]
            mine = torch.cat([self.local(k, tensors[k]).movedim(self.axes[k], 0).reshape(-1)
                              for k in keys])
            rows = torch.empty(self.world * mine.numel(), dtype=mine.dtype, device=mine.device)
            dist.all_gather_into_tensor(rows, mine, group=self.group)
            rows = rows.view(self.world, -1)
            o = 0
            for k in keys:
                full = tensors[k]
                m = full.numel() // self.world
                full.copy_(self._unflatten(k, rows[:, o:o + m], full))
                o += m

    def gather(self, slices: Tensors) -> Tensors:
        """Full tensors from every rank's slices (split keys), on every rank;
        the others as they are."""
        out = {}
        for k, v in slices.items():
            if k in self.axes:
                shape = list(v.shape)
                shape[self.axes[k]] *= self.world
                out[k] = torch.empty(shape, dtype=v.dtype, device=v.device)
                self.local(k, out[k]).copy_(v)
            else:
                out[k] = v
        self.all_gather(out)
        return out

    def scatter(self, full: Tensors) -> Tensors:
        """This rank's slices (copies) of the split tensors of ``full``; the
        others as they are."""
        return {k: self.local(k, v).clone() if k in self.axes else v for k, v in full.items()}


class ZeroShard(AxisSplit):
    """A trainer's ZeRO-1 layout over the data ranks ``group``: which of its
    tensors (by the names of its parameters, whole ``shapes``) are split
    over the ranks, and along which axis (``axes``). With ``zero1`` off
    nothing is split and every rank holds every tensor whole; the gradient
    reduction is then one all-reduce. ``tensor`` (an :class:`AxisSplit`
    over the tensor group) names the tensors the tensor rule splits: each
    rank's tensors are then its tensor slices, and ZeRO-1 cuts those along
    another axis.

    A split tensor's gradient reaches its rank by a reduce-scatter (each
    rank gets the mean of its slice), its moments, accumulator and EMA
    shadow live as the slice, the optimiser updates the slice of the master,
    and :meth:`all_gather` rebuilds the master on every rank."""

    def __init__(self, shapes: Dict[str, torch.Size], group=None, zero1: bool = False,
                 tensor: Optional[AxisSplit] = None):
        world = dist.get_world_size(group)
        self.tensor = tensor
        taxes = tensor.axes if tensor is not None else {}
        axes = {}
        if zero1:
            for k, shape in shapes.items():
                axis = zero1_spec(tuple(shape), world, tensor_axis=taxes.get(k))
                if axis is not None:
                    axes[k] = axis
        super().__init__(axes, group)

    def _rank_major(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """[world, slice elements]: row r is rank r's slice, flattened."""
        return full.movedim(self.axes[key], 0).reshape(self.world, -1)

    def reduce_gradients(self, grads: Tensors) -> Tensors:
        """The group's mean gradient: this rank's slice of each split
        tensor (reduce-scatter), each other tensor whole (all-reduce), in
        flat buckets."""
        whole = [k for k in grads if k not in self.axes]
        out = all_reduce_mean({k: grads[k] for k in whole}, self.group) if whole else {}
        split = [k for k in grads if k in self.axes]
        for members, _, _ in _buckets([grads[k] for k in split]):
            keys, split = split[:len(members)], split[len(members):]
            rows = torch.cat([self._rank_major(k, grads[k]) for k in keys], dim=1)
            mine = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
            dist.reduce_scatter_tensor(mine, rows.reshape(-1), group=self.group)
            mine.div_(self.world)
            o = 0
            for k in keys:
                m = grads[k].numel() // self.world
                out[k] = self._unflatten(k, mine[o:o + m], self.local(k, grads[k]))
                o += m
        out = {k: out[k] for k in grads}
        if self.tensor is not None:
            # each rank of a tensor group computes the leaves the tensor rule
            # keeps whole on its own, and on the card two ranks need not get
            # the same bits: tensor rank 0's are everyone's
            _broadcast([v for k, v in out.items() if k not in self.tensor.axes],
                       self.tensor.group)
        return out

    def norm(self, tensors: Tensors, norm: Callable[[Tensors], torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole tensors, from this rank's slices:
        the sums of squares of ZeRO-1's slices summed over the data group,
        those of the tensor slices over the tensor group, the whole tensors'
        counted once. ``norm`` is the plain global norm, which takes
        everything where nothing is split."""
        taxes = self.tensor.axes if self.tensor is not None else {}
        if not any(k in taxes for k in tensors):
            split = [k for k in tensors if k in self.axes]
            if not split:
                return norm(tensors)
            whole = [k for k in tensors if k not in self.axes]
            sq = torch.stack([(tensors[k] * tensors[k]).sum() for k in split]).sum()
            dist.all_reduce(sq, group=self.group)
            if whole:
                sq = sq + norm({k: tensors[k] for k in whole}) ** 2
            return torch.sqrt(sq)
        # [ZeRO only, ZeRO and tensor, tensor only, neither]
        t = next(iter(tensors.values()))
        parts = torch.zeros(4, dtype=torch.float32, device=t.device)
        for k, v in tensors.items():
            if k in self.axes:
                parts[1 if k in taxes else 0] += (v * v).sum()
            else:
                parts[2 if k in taxes else 3] += (v * v).sum()
        ranked = parts[:2].clone()
        dist.all_reduce(ranked, group=self.group)
        over_tensor = torch.stack([ranked[1], parts[2]])
        dist.all_reduce(over_tensor, group=self.tensor.group)
        return torch.sqrt(ranked[0] + over_tensor.sum() + parts[3])


_MOMENT_FIELDS = ("opt_state", "opt_g", "opt_d")


def _map_state(state, fn, fields=("ema",)):
    """``state`` with ``fn`` applied to its moments and accumulators (the
    optimiser states' ``mu``, ``nu``, ``acc``) and to the dicts of tensors
    of ``fields``."""
    updates = {}
    for f in state._fields:
        value = getattr(state, f)
        if f in _MOMENT_FIELDS:
            updates[f] = {k: (fn(v) if k in ("mu", "nu", "acc") and v is not None else v)
                          for k, v in value.items()}
        elif f in fields and value is not None:
            updates[f] = fn(value)
    return state._replace(**updates)


# the dicts of a training state that the tensor rule splits (the moments and
# accumulators too); the frozen towers are split in the modules themselves
_TENSOR_FIELDS = ("trainable", "disc", "ema")


def shard_state(state, zero: ZeroShard):
    """A full training state (stage 1's or stage 2's) -> this rank's: every
    tensor the tensor rule splits cut to this rank's tensor slice, then the
    moments, accumulators and EMA shadows cut to its ZeRO-1 slices; the
    rest whole."""
    if zero.tensor is not None:
        state = _map_state(state, zero.tensor.scatter, _TENSOR_FIELDS)
    return _map_state(state, zero.scatter)


def gather_state(state, zero: ZeroShard):
    """The inverse of :func:`shard_state`, collective: every rank calls it
    and gets the full state (rank 0 writes it)."""
    state = _map_state(state, zero.gather)
    if zero.tensor is not None:
        state = _map_state(state, zero.tensor.gather, _TENSOR_FIELDS)
    return state


def _broadcast(tensors: List[torch.Tensor], group=None) -> None:
    """Rank 0 of ``group``'s ``tensors`` on every rank of it, in place, in
    flat buckets."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for members, offsets, total in _buckets(tensors):
        flat = _packed(members, offsets, total)
        dist.broadcast(flat, src, group=group)
        for t, o in zip(members, offsets):
            t.copy_(flat[o:o + t.numel()].view(t.shape))


def _state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a training state but the frozen towers, in a fixed
    order."""
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            for k in sorted(v):
                walk(v[k])

    for f in state._fields:
        if f != "frozen":
            walk(getattr(state, f))
    return out


def broadcast_state(state, group=None):
    """Rank 0's full training state on every rank of ``group``, in place:
    each rank passes a state of the same layout (its own initial one) and
    gets rank 0's tensors and counts (step, the optimisers' counters)."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    _broadcast(_state_tensors(state), group)
    counts = [{f: getattr(state, f) for f in state._fields if isinstance(getattr(state, f), int)},
              {f: {k: v for k, v in getattr(state, f).items() if isinstance(v, int)}
               for f in _MOMENT_FIELDS if f in state._fields}]
    dist.broadcast_object_list(counts, src, group=group)
    scalars, opt_counts = counts
    for f, c in opt_counts.items():
        getattr(state, f).update(c)
    return state._replace(**scalars)
