"""Cross-stage partial weight load (the port's counterpart of
``evoke_tpu/core/checkpoint.py`` ``CheckpointManager.partial_restore_from``).

The reference seeds a stage from another stage's weights with
``load_state_dict(strict=False)`` (trainer_v0401.py:191-202): every target
entry whose name and shape match a source entry is loaded, the rest keep their
values. The port reads a ``torch.save`` file of a flat state dict, for example
``save_state_dict(params.flax_to_state_dict(jax_variables), path)``; it does
not read orbax checkpoints. Full training checkpoints are ROADMAP A10.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def save_state_dict(state_dict: Mapping[str, object], path: str) -> None:
    """``torch.save`` a flat state dict, numpy values as tensors (so the file
    loads with ``weights_only=True``)."""
    torch.save({k: torch.from_numpy(np.array(v)) if not torch.is_tensor(v) else v
                for k, v in state_dict.items()}, path)


def partial_restore(source: Mapping[str, object], module: torch.nn.Module
                    ) -> Dict[str, int]:
    """Copy every ``source`` entry whose name and shape match ``module``'s
    state dict into it (cast to the target's dtype and device). Returns counts:
    ``loaded``; ``missing`` (target entries the source lacks); ``skipped``
    (source entries not loaded: unknown names or other shapes)."""
    target = module.state_dict()
    merged = {}
    for key, tgt in target.items():
        src = source.get(key)
        if src is not None and tuple(np.shape(src)) == tuple(tgt.shape):
            merged[key] = torch.as_tensor(np.asarray(src) if not torch.is_tensor(src) else src)
    module.load_state_dict(merged, strict=False)
    return {"loaded": len(merged), "missing": len(set(target) - set(source)),
            "skipped": len(source) - len(merged)}


def partial_restore_from(path: str, module: torch.nn.Module) -> Dict[str, int]:
    """``partial_restore`` from a ``torch.save``d state dict file."""
    source = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(source, Mapping):
        raise TypeError(f"{path}: expected a state dict, got {type(source).__name__}")
    return partial_restore(source, module)
