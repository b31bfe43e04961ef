"""The process group of a multi-device restore or training run: one process
per device.

Counterpart of ``mgldvsr_tpu/parallel/mesh.py``. The serving half
(``make_mesh`` and ``init_multihost``) is :func:`init_group` and
:func:`subgroup`. The trainer half is data parallelism: every rank takes one
clip a micro-step (JAX's one clip per ``data`` slot), the ranks average
their float32 gradients (:func:`all_reduce_mean`, JAX's ``psum`` inside the
jitted step), and :class:`ZeroShard` splits the optimiser moments, the
accumulator and the EMA over the ranks with the JAX package's ZeRO-1 rule
(``_zero1_spec``: the largest axis the world divides, leaves of at least
``ZERO1_MIN_SIZE`` elements), while the parameters stay replicated.
:func:`shard_state`, :func:`gather_state` and :func:`broadcast_state` move a
trainer's state between the full layout of a checkpoint and the ranks'
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

import datetime
import math
import os
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
# leaves below this many elements stay whole on every rank under ZeRO-1 (the
# JAX package's constant; tests lower it to split the tiny models' leaves)
ZERO1_MIN_SIZE = 65536
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


def zero1_spec(shape, dp: int, min_size: Optional[int] = None) -> Optional[int]:
    """The JAX package's ZeRO-1 rule (``_zero1_spec``) for a tensor with no
    tensor-parallel axis: the largest axis that ``dp`` divides (and that is
    at least ``dp`` long; the first of equal ones), or None where ``dp`` is
    1, the tensor has fewer than ``min_size`` elements (default
    ``ZERO1_MIN_SIZE``, read at call time) or no axis qualifies."""
    min_size = ZERO1_MIN_SIZE if min_size is None else min_size
    if dp <= 1 or math.prod(shape) < min_size:
        return None
    best = None
    for i, n in enumerate(shape):
        if n % dp == 0 and n >= dp and (best is None or n > shape[best]):
            best = i
    return best


class ZeroShard:
    """A trainer's data-parallel layout over ``group``: which of its tensors
    (by the names of its parameters) are split over the ranks, and along
    which axis (``axes``). With ``zero1`` off nothing is split and every
    rank holds every tensor whole; the gradient reduction is then one
    all-reduce. Each rank's slice of a split tensor is the ``rank``-th of
    ``world`` equal pieces along its axis.

    A split tensor's gradient reaches its rank by a reduce-scatter (each
    rank gets the mean of its slice), its moments, accumulator and EMA
    shadow live as the slice, the optimiser updates the slice of the master,
    and :meth:`all_gather` rebuilds the full master on every rank."""

    def __init__(self, shapes: Dict[str, torch.Size], group=None, zero1: bool = False):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.axes = {}
        if zero1:
            for k, shape in shapes.items():
                axis = zero1_spec(tuple(shape), self.world)
                if axis is not None:
                    self.axes[k] = axis

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

    # -- collectives -----------------------------------------------------------

    def _rank_major(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """[world, slice elements]: row r is rank r's slice, flattened."""
        return full.movedim(self.axes[key], 0).reshape(self.world, -1)

    def _unflatten(self, key: str, rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Rows of slices [world, m] (or one row [m]) back to the layout of
        ``like`` (the full tensor, or a slice) along the key's axis."""
        axis = self.axes[key]
        moved = like.movedim(axis, 0).shape
        return rows.reshape(moved).movedim(0, axis)

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
        return {k: out[k] for k in grads}

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

    def norm(self, tensors: Tensors, norm: Callable[[Tensors], torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole tensors, from this rank's slices of
        the split ones: the slices' sums of squares summed over the group,
        plus the whole tensors'. ``norm`` is the plain global norm, which
        takes everything where nothing is split."""
        split = [k for k in tensors if k in self.axes]
        if not split:
            return norm(tensors)
        whole = [k for k in tensors if k not in self.axes]
        sq = torch.stack([(tensors[k] * tensors[k]).sum() for k in split]).sum()
        dist.all_reduce(sq, group=self.group)
        if whole:
            sq = sq + norm({k: tensors[k] for k in whole}) ** 2
        return torch.sqrt(sq)


_MOMENT_FIELDS = ("opt_state", "opt_g", "opt_d")


def _map_state(state, zero: ZeroShard, fn):
    """``state`` with ``fn`` applied to its moments, accumulators (the
    optimiser states' ``mu``, ``nu``, ``acc``) and EMA shadows."""
    updates = {}
    for f in state._fields:
        value = getattr(state, f)
        if f in _MOMENT_FIELDS:
            updates[f] = {k: (fn(v) if k in ("mu", "nu", "acc") and v is not None else v)
                          for k, v in value.items()}
        elif f == "ema" and value is not None:
            updates[f] = fn(value)
    return state._replace(**updates)


def shard_state(state, zero: ZeroShard):
    """A full training state (stage 1's or stage 2's) -> this rank's: the
    moments, accumulators and EMA shadows cut to its slices; the masters and
    everything else whole."""
    return _map_state(state, zero, zero.scatter)


def gather_state(state, zero: ZeroShard):
    """The inverse of :func:`shard_state`, collective: every rank calls it
    and gets the full state (rank 0 writes it)."""
    return _map_state(state, zero, zero.gather)


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
    for members, offsets, total in _buckets(_state_tensors(state)):
        flat = _packed(members, offsets, total)
        dist.broadcast(flat, src, group=group)
        for t, o in zip(members, offsets):
            t.copy_(flat[o:o + t.numel()].view(t.shape))
    counts = [{f: getattr(state, f) for f in state._fields if isinstance(getattr(state, f), int)},
              {f: {k: v for k, v in getattr(state, f).items() if isinstance(v, int)}
               for f in _MOMENT_FIELDS if f in state._fields}]
    dist.broadcast_object_list(counts, src, group=group)
    scalars, opt_counts = counts
    for f, c in opt_counts.items():
        getattr(state, f).update(c)
    return state._replace(**scalars)
