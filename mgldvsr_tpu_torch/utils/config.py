"""Configs: YAML files merged left to right, ``key.path=value`` overrides,
dicts applied onto dataclasses, and a registry of named constructors.

Counterpart of ``mgldvsr_tpu/utils/config.py``. ``instantiate`` builds a
``{"target": name, "params": {...}}`` node through ``REGISTRY``, which holds
the three datasets, RAFT and SpyNet under the JAX package's names; a target
name that is not registered fails with the registered ones listed. ``yaml``
is imported only when a file is loaded.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_BOOLS = {"true": True, "false": False}

REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    """Decorator: register ``fn`` under ``name`` for :func:`instantiate`."""
    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


def load_yaml(path: str) -> Dict:
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(f"reading the config file {path} needs PyYAML, which is not "
                           f"installed; pass settings with --set instead") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def merge(*dicts: Dict) -> Dict:
    """Deep merge, later dicts win."""
    out: Dict = {}
    for d in dicts:
        for k, v in (d or {}).items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = merge(out[k], v)
            else:
                out[k] = v
    return out


def apply_dotlist(cfg: Dict, overrides: List[str]) -> Dict:
    """Apply ``["model.dec_w=0.5", ...]`` in place: the value is a Python
    literal where it parses as one, else the string."""
    for item in overrides:
        key, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg


def load_config(paths: List[str], overrides: Optional[List[str]] = None) -> Dict:
    cfg = merge(*[load_yaml(p) for p in paths])
    if overrides:
        apply_dotlist(cfg, overrides)
    return cfg


def instantiate(spec: Dict, **extra) -> Any:
    """``{"target": name, "params": {...}}`` -> ``REGISTRY[name](**params,
    **extra)``."""
    if "target" not in spec:
        raise KeyError(f"config node missing 'target': {list(spec)}")
    name = spec["target"]
    if name not in REGISTRY:
        raise KeyError(f"unknown target {name!r}; registered: {sorted(REGISTRY)}")
    params = dict(spec.get("params") or {})
    params.update(extra)
    return REGISTRY[name](**params)


def apply_to_dataclass(instance, cfg: Optional[Dict]):
    """``cfg`` applied on top of a dataclass instance with
    ``dataclasses.replace``: values the instance already holds survive keys
    the config does not name. Nested dataclasses recurse, lists become
    tuples where the field holds a tuple, ``dtype`` takes the names
    "float32", "bfloat16" and "float16", and a bool field takes "true" /
    "false" in any case (``--set model.unet.use_temporal=false`` reaches
    the config as that string; the JAX loader keeps the string, which is
    truthy) and refuses any other string. An unknown key raises
    ``KeyError`` naming the valid ones; a dataclass's own checks (e.g.
    ``RAFTConfig.lookup_impl``) raise ``ValueError``."""
    fields = {f.name for f in dataclasses.fields(instance)}
    kwargs: Dict[str, Any] = {}
    for key, value in (cfg or {}).items():
        if key not in fields:
            raise KeyError(f"{type(instance).__name__}: unknown config key {key!r}; "
                           f"valid: {sorted(fields)}")
        current = getattr(instance, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            value = apply_to_dataclass(current, value)
        elif key == "dtype" and isinstance(value, str):
            if value not in _DTYPES:
                raise KeyError(f"dtype {value!r}; valid: {sorted(_DTYPES)}")
            value = _DTYPES[value]
        elif isinstance(current, bool) and isinstance(value, str):
            if value.lower() not in _BOOLS:
                raise ValueError(f"{type(instance).__name__}.{key}: {value!r} is not a bool; "
                                 f"use true or false")
            value = _BOOLS[value.lower()]
        elif isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        kwargs[key] = value
    return dataclasses.replace(instance, **kwargs)


def build_dataclass(cls, cfg: Optional[Dict]):
    """``cls()`` with ``cfg`` applied (every field of ``cls`` needs a
    default)."""
    return apply_to_dataclass(cls(), cfg)


def pipeline_config_from_dict(cfg: Optional[Dict]):
    """The ``model:`` subtree of a config -> ``PipelineConfig``.
    ``model.num_frames`` reaches the unet, structcond and vae sub-configs
    unless a subtree sets its own: their temporal layers fold the frames
    axis by it."""
    from mgldvsr_tpu_torch.infer.pipeline import PipelineConfig

    cfg = dict(cfg or {})
    pc = build_dataclass(PipelineConfig, cfg)
    if "num_frames" in cfg:
        t = cfg["num_frames"]
        for name in ("unet", "structcond", "vae"):
            if "num_frames" not in (cfg.get(name) or {}):
                pc = dataclasses.replace(
                    pc, **{name: dataclasses.replace(getattr(pc, name), num_frames=t)})
    return pc


def _register_defaults():
    from mgldvsr_tpu_torch.data.datasets import REDSAutoencoderDataset, RealVSRRecurrentDataset
    from mgldvsr_tpu_torch.data.video_folder import VideoFolderDataset
    from mgldvsr_tpu_torch.flow.raft import RAFT, RAFTConfig
    from mgldvsr_tpu_torch.flow.spynet import SpyNet

    REGISTRY.setdefault("data.realvsr_recurrent", RealVSRRecurrentDataset)
    REGISTRY.setdefault("data.reds_autoencoder", REDSAutoencoderDataset)
    REGISTRY.setdefault("data.video_folder", VideoFolderDataset)
    REGISTRY.setdefault("flow.raft", lambda **kw: RAFT(RAFTConfig(**kw)))
    REGISTRY.setdefault("flow.spynet", lambda **kw: SpyNet(**kw))


_register_defaults()
