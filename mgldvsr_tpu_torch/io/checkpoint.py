"""Training checkpoints over ``torch.save``, with auto-resume and
signal-triggered snapshots.

Counterpart of ``mgldvsr_tpu/io/checkpoint.py`` (orbax there):

- ``CheckpointManager`` keeps numbered step directories
  (``<dir>/<step>/state.pt`` and ``metrics.json``), at most ``max_to_keep``
  of them: the newest, or with ``best_fn`` the best by that metric (the
  newest is always kept too). Each is written under a temporary name and
  renamed, so a directory either holds a whole checkpoint or is absent.
- ``install_signal_save``: SIGUSR1 saves the current state at once, or
  right after the micro-step in flight.
- ``save_params`` / ``load_params``: one flat dict of tensors in a file.

A training state is saved without its frozen towers: they are rebuilt from
the seed or the initial checkpoint, never written at every step.
``torch.load`` unpickles: load only checkpoints from a trusted source.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
from typing import Any, Callable, Dict, Optional

import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _onto(saved, like):
    """``saved`` with each tensor moved to the device and dtype of the
    tensor at the same place in ``like``."""
    if isinstance(saved, torch.Tensor):
        if isinstance(like, torch.Tensor):
            return saved.to(device=like.device, dtype=like.dtype)
        return saved
    if isinstance(saved, dict):
        return {k: _onto(v, like.get(k) if isinstance(like, dict) else None)
                for k, v in saved.items()}
    return saved


def state_payload(state) -> Dict[str, Any]:
    """What a checkpoint holds of a training state (a NamedTuple with a
    ``frozen`` field, stage 1's or stage 2's): every field but the frozen
    towers. Anything else is saved whole."""
    if hasattr(state, "_fields") and "frozen" in state._fields:
        return {"kind": "train_state",
                **{f: getattr(state, f) for f in state._fields if f != "frozen"}}
    return {"kind": "object", "value": state}


class CheckpointManager:
    """Numbered checkpoints of training states (or any tensors) in one
    directory."""

    def __init__(self, directory: str, max_to_keep: int = 20, save_interval_steps: int = 1,
                 best_fn: Optional[Callable[[dict], float]] = None, best_mode: str = "min"):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.best_fn = best_fn
        self.best_mode = best_mode
        self.signal_pending = False  # set by install_signal_save's handler

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d,
                                                                     "state.pt")))

    def _metrics(self, step: int) -> Optional[dict]:
        path = os.path.join(self.directory, str(step), "metrics.json")
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save(self, step: int, state: Any, metrics: Optional[dict] = None,
             force: bool = False) -> bool:
        """Write ``state`` as step ``step`` when ``step`` is a multiple of
        ``save_interval_steps`` (or ``force``) and not saved yet; returns
        whether it wrote."""
        if step in self.all_steps():
            return False
        if not force and step % self.save_interval_steps:
            return False
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_to_cpu(state_payload(state)), os.path.join(tmp, "state.pt"))
        if metrics is not None:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        os.rename(tmp, final)
        self._prune()
        return True

    def _prune(self) -> None:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        keep = set(steps[-self.max_to_keep:])
        if self.best_fn is not None:
            scored = [(self.best_fn(m), s) for s in steps if (m := self._metrics(s)) is not None]
            scored.sort(reverse=self.best_mode == "max")
            keep = {s for _, s in scored[:self.max_to_keep]} | {steps[-1]}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The checkpoint of ``step`` (default: the latest). With a
        ``template`` training state, a state of its type with the template's
        frozen towers and each saved tensor on the template's device and
        dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(os.path.join(self.directory, str(step), "state.pt"),
                             map_location="cpu", weights_only=False)
        if payload["kind"] != "train_state":
            return payload["value"]
        if template is None:
            return payload
        return template._replace(**{f: _onto(payload[f], getattr(template, f))
                                    for f in template._fields if f != "frozen"})

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if self.best_fn is None:
            return None
        scored = [(self.best_fn(m), s) for s in self.all_steps()
                  if (m := self._metrics(s)) is not None]
        if not scored:
            return None
        return (min if self.best_mode == "min" else max)(scored)[1]

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


def install_signal_save(get_state: Callable[[], Optional[tuple]], mgr: CheckpointManager):
    """SIGUSR1 -> a forced checkpoint of ``get_state()``'s (step, state).
    ``get_state`` returns None while a micro-step is updating the state in
    place; the save then waits for the caller, which finds
    ``mgr.signal_pending`` set after the step and saves."""

    def handler(signum, frame):
        current = get_state()
        if current is None:
            mgr.signal_pending = True
            print("signal save deferred to the end of the micro-step in flight", flush=True)
            return
        step, state = current
        mgr.save(step, state, force=True)

    signal.signal(signal.SIGUSR1, handler)
    return handler


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """One flat dict of tensors, written under a temporary name and renamed."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(_to_cpu(dict(params)), tmp)
    os.replace(tmp, path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=False)
