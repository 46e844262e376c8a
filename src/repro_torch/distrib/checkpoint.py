"""Checkpointing + restart: the fault-tolerance substrate on one device.

The port of ``repro.distrib.checkpoint``, with the reference's protocol:

  * **atomic**: write to ``step_N.tmp/`` then rename — a checkpoint is
    either complete or absent; a crash mid-save never corrupts the latest,
    and a stale ``.tmp`` is replaced by the next save of that step;
  * **versioned**: ``step_N`` directories; ``latest()`` resolves the
    highest complete one; ``keep`` bounds disk usage;
  * **self-describing**: each tree is stored flat (``path -> tensor``,
    paths joined with ``/``; a module's parameters under their names) with
    a JSON manifest (step, the caller's ``extra`` such as the
    data-iterator state, and the format).

The on-disk format is the port's own (``repro-torch-ckpt-v1``): one
``torch.save`` file a tree, tensors moved to the host, dtypes kept
(bfloat16 and int included).  ``restore`` rebuilds the template's tree
with each tensor cast to the template leaf's dtype and device; a module
template gets the values copied into its parameters.

Sharded state (DTensors, ``distrib.sharding.device_put``) is saved whole:
every leaf is gathered (a collective, so every rank calls :meth:`save`,
and only the one with ``write=True`` writes), and a DTensor template
leaf takes its own shard of the stored whole tensor on restore (each
rank reads the file; no collective).  A checkpoint is so independent of
the mesh that wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .sharding import full, is_dtensor

FORMAT = "repro-torch-ckpt-v1"


def _fields(tree) -> Optional[Dict[str, Any]]:
    """The children of an inner node by key, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, dict):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return tree._asdict()                   # AdamWState
    return None


def _flatten(tree, prefix: str = "", keep: bool = True
             ) -> Dict[str, torch.Tensor]:
    """``path -> tensor`` on the host; a DTensor leaf is gathered whole
    (every rank takes part), and kept only where ``keep``, one leaf at a
    time."""
    kids = _fields(tree)
    if kids is None:
        whole = full(torch.as_tensor(tree).detach())
        return {prefix: whole.cpu()} if keep else {}
    out = {}
    for k, v in kids.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k), keep))
    return out


@torch.no_grad()
def _unflatten_into(template, arrays: Dict[str, torch.Tensor],
                    prefix: str = ""):
    kids = _fields(template)
    if kids is None:
        ref = torch.as_tensor(template)
        if is_dtensor(ref):
            from torch.distributed.tensor import distribute_tensor

            whole = arrays[prefix].to(device=ref.device, dtype=ref.dtype)
            return distribute_tensor(whole, ref.device_mesh, ref.placements,
                                     src_data_rank=None)
        return arrays[prefix].to(device=ref.device, dtype=ref.dtype)
    built = {k: _unflatten_into(v, arrays, f"{prefix}/{k}" if prefix
                                else str(k)) for k, v in kids.items()}
    if isinstance(template, nn.Module):
        for k, p in kids.items():
            p.copy_(built[k])
        return template
    if isinstance(template, dict):
        return built
    return type(template)(**built)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state=None,
             extra: Optional[Dict[str, Any]] = None, write: bool = True
             ) -> str:
        """Writes step ``step`` and returns its directory.  With sharded
        state every rank calls this (the leaves are gathered) and only
        the one with ``write`` writes."""
        final = self._dir(step)
        flat_params = _flatten(params, keep=write)
        flat_opt = _flatten(opt_state, keep=write) \
            if opt_state is not None else None
        if not write:
            return final
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(flat_params, os.path.join(tmp, "params.pt"))
        if flat_opt is not None:
            torch.save(flat_opt, os.path.join(tmp, "opt_state.pt"))
        manifest = {"step": step, "extra": extra or {}, "format": FORMAT}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.rename(tmp, final)            # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, params_template, opt_template=None
                ) -> Tuple[Any, Any, Dict[str, Any]]:
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{d}: format {manifest.get('format')!r}, "
                             f"expected {FORMAT!r}")
        arrays = torch.load(os.path.join(d, "params.pt"), weights_only=True)
        params = _unflatten_into(params_template, arrays)
        opt_state = None
        if opt_template is not None:
            opt_arrays = torch.load(os.path.join(d, "opt_state.pt"),
                                    weights_only=True)
            opt_state = _unflatten_into(opt_template, opt_arrays)
        return params, opt_state, manifest["extra"]
