"""Upstream PyTorch checkpoints into the port's towers.

The port's modules keep the upstream state-dict key names and layouts, so
loading is prefix work and ``load_state_dict(strict=True)``, with no
conversion. As the JAX package's loader does
(``mgldvsr_tpu/io/ckpt_convert.py``: ``load_torch_state_dict``,
``apply_litema_shadows``, ``convert_mgld_checkpoint``):

- the state dict is unwrapped from ``state_dict``, ``params``,
  ``params_ema`` or ``model`` and a DDP ``module.`` prefix is stripped;
- LitEma shadows (``model_ema.<name without dots>``) replace the
  ``model.*`` weights they shadow: upstream samples inside ``ema_scope``;
- an MGLD-VSR checkpoint splits by prefix: ``model.diffusion_model.`` is
  the UNet, ``structcond_stage_model.`` the struct-cond encoder,
  ``first_stage_model.`` the VAE, ``cond_stage_model.model.`` the OpenCLIP
  text tower. A video VAE checkpoint has no prefix; RAFT's is
  ``raft-things``.

Keys the upstream modules hold and the port's towers do not compute are
dropped before the strict load (:data:`UPSTREAM_ONLY`): OpenCLIP's vision
tower, projection, scale and last block (the port stops at the
penultimate), a VAE's training loss, BatchNorm's step counters. Any other
missing or unexpected key raises.

``torch.load`` here unpickles: load only checkpoints from a trusted source.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

TOWER_PREFIXES = {
    "unet": "model.diffusion_model.",
    "structcond": "structcond_stage_model.",
    "vae": "first_stage_model.",
    "clip": "cond_stage_model.model.",
}
# prefixes of the upstream names each tower's port does not hold
UPSTREAM_ONLY = {
    "clip": ("visual.", "logit_scale", "text_projection", "attn_mask"),
    "vae": ("loss.",),
}

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """The checkpoint's flat state dict, unwrapped, ``module.`` stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "params", "params_ema", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {(k[7:] if k.startswith("module.") else k): v for k, v in obj.items()}


def apply_litema_shadows(sd: Mapping[str, torch.Tensor]) -> Tuple[StateDict, int]:
    """(state dict with every shadowed ``model.*`` weight replaced by its
    ``model_ema.*`` shadow, the number replaced). A shadow's name is its
    weight's name after ``model.`` with the dots removed; two weights whose
    names collapse to one shadow name, or a shadow with no weight, raise."""
    shadows = {k[len("model_ema."):]: v for k, v in sd.items()
               if k.startswith("model_ema.")
               and k not in ("model_ema.decay", "model_ema.num_updates")}
    out = dict(sd)
    if not shadows:
        return out, 0
    owner: Dict[str, str] = {}
    for k in sd:
        if not k.startswith("model."):
            continue
        flat = k[len("model."):].replace(".", "")
        if flat in owner:
            raise ValueError(f"ambiguous LitEma name {flat!r}: {owner[flat]!r} and {k!r}")
        owner[flat] = k
    unmatched = set(shadows) - set(owner)
    if unmatched:
        raise KeyError(f"{len(unmatched)} model_ema.* shadows have no model.* weight, e.g. "
                       f"{sorted(unmatched)[:3]}")
    for flat, v in shadows.items():
        out[owner[flat]] = v
    return out, len(shadows)


def _upstream_only(tower: str, name: str, module: torch.nn.Module) -> bool:
    if name.startswith(UPSTREAM_ONLY.get(tower, ())) or name.endswith(".num_batches_tracked"):
        return True
    if tower == "clip" and name.startswith("transformer.resblocks."):
        # a tower that stops at the penultimate block holds one block fewer
        return int(name.split(".")[2]) >= len(module.transformer.resblocks)
    return False


def tower_state_dict(sd: Mapping[str, torch.Tensor], prefix: str, tower: str,
                     module: torch.nn.Module) -> StateDict:
    """The keys under ``prefix``, the prefix cut, less those the upstream
    ``tower`` holds and ``module`` does not compute."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not _upstream_only(tower, k[len(prefix):], module)}


def load_tower(module: torch.nn.Module, sd: Mapping[str, torch.Tensor], prefix: str = "",
               tower: str = "") -> None:
    """Strict load of the keys under ``prefix`` into ``module``."""
    module.load_state_dict(tower_state_dict(sd, prefix, tower, module), strict=True)


def load_mgld_checkpoint(pipe, sd: Mapping[str, torch.Tensor],
                         towers=tuple(TOWER_PREFIXES)) -> int:
    """Load an MGLD-VSR state dict, its LitEma shadows applied, into the
    pipeline's ``towers`` (of the UNet, struct-cond encoder, VAE and text
    tower; RAFT ships on its own); returns the number of shadows applied."""
    sd, n_ema = apply_litema_shadows(sd)
    for name in towers:
        load_tower(pipe.towers()[name], sd, TOWER_PREFIXES[name], name)
    return n_ema


def load_pipeline_checkpoints(pipe, torch_ckpt: str, vqgan_ckpt: str | None = None,
                              raft_ckpt: str | None = None) -> int:
    """The inference CLI's three checkpoint files into ``pipe``: the
    MGLD-VSR checkpoint, and optionally an unprefixed video VAE with fusion
    (which then takes the VAE's place: an MGLD-VSR checkpoint may hold the
    image VAE alone) and a ``raft-things`` RAFT. Returns the LitEma shadows
    applied."""
    towers = [n for n in TOWER_PREFIXES if not (vqgan_ckpt and n == "vae")]
    n_ema = load_mgld_checkpoint(pipe, load_torch_state_dict(torch_ckpt), towers=towers)
    if vqgan_ckpt:
        load_tower(pipe.vae, load_torch_state_dict(vqgan_ckpt), "", "vae")
    if raft_ckpt:
        load_tower(pipe.raft, load_torch_state_dict(raft_ckpt), "", "raft")
    return n_ema
