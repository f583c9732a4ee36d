"""Flax variables -> the port's ``state_dict``, and the port's own seeded init.

The port's modules carry the flax module names attribute for attribute, so a
flax path ``params/a/b/<leaf>`` becomes the torch key ``a.b.<name>``:

    Dense kernel [in, out]     -> weight [out, in]
    Conv kernel HWIO           -> weight OIHW
    bias                       -> bias
    LayerNorm / BatchNorm scale-> weight
    Embed embedding            -> weight
    TorchLayerNorm / CLN gamma, beta -> gamma, beta
    raw self.param leaves cls, pos_embed (ViT), memory_matrix (CMN) -> same name
    batch_stats mean, var      -> running_mean, running_var

This is the inverse of ``evoke_tpu/models/torch_import.py:59-64``. Loading
fails loudly on any missing, unused or mis-shaped key.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"bias": "bias", "scale": "weight", "embedding": "weight",
                 "gamma": "gamma", "beta": "beta", "cls": "cls", "pos_embed": "pos_embed",
                 "memory_matrix": "memory_matrix"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{'params': ..., 'batch_stats': ...} (nested dicts of arrays) -> flat
    torch-named numpy arrays in torch layouts."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _walk(variables["params"]):
        a = np.asarray(leaf)
        name = path[-1]
        if name == "kernel":
            if a.ndim == 2:
                a, tname = a.T, "weight"
            elif a.ndim == 4:
                a, tname = a.transpose(3, 2, 0, 1), "weight"
            else:
                raise ValueError(f"kernel {'/'.join(path)} has rank {a.ndim}")
        elif name in _PARAM_LEAVES:
            tname = _PARAM_LEAVES[name]
        else:
            raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (tname,))] = np.ascontiguousarray(a)
    for path, leaf in _walk(variables.get("batch_stats", {})):
        if path[-1] not in _STAT_LEAVES:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (_STAT_LEAVES[path[-1]],))] = np.asarray(leaf)
    return out


def load_flax_variables(module: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy JAX ``FinetuneModel`` (or sub-module) variables into ``module``.

    Values are cast to each torch parameter's dtype (a bf16 model stores its
    compute-dtype weights in bf16, rounding as flax's per-use cast does)."""
    sd = flax_to_state_dict(variables)
    want = module.state_dict()
    missing = sorted(set(want) - set(sd))
    unused = sorted(set(sd) - set(want))
    bad = sorted(k for k in set(sd) & set(want) if tuple(sd[k].shape) != tuple(want[k].shape))
    if missing or unused or bad:
        raise KeyError(
            f"flax -> torch load: missing {missing[:20]} ({len(missing)}), unused "
            f"{unused[:20]} ({len(unused)}), shape mismatch "
            f"{[(k, sd[k].shape, tuple(want[k].shape)) for k in bad[:20]]}")
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)


@torch.no_grad()
def init_params_(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """The port's own seeded init (for runs without JAX weights): weights of
    rank >= 2 ~ N(0, 1/fan_in), norm scales 1, biases and shifts 0, running
    statistics (0, 1). Draws come from one explicit ``torch.Generator`` on the
    module's device, in ``named_parameters`` order."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim >= 2:
            # stacked expert matrices [E, out, in] take one expert's fan-in
            fan_in = p.shape[-1] if p.ndim == 3 else p[0].numel()
            p.copy_(torch.randn(p.shape, generator=g, device=dev) / fan_in ** 0.5)
        elif leaf in ("weight", "gamma"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, buf in module.named_buffers():
        if name.endswith("running_mean"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)
    return module
