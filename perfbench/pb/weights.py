"""Model weights drawn from the run's seed, on the device, in a few calls.

One ``torch.Generator`` on the device, seeded with the run's seed, draws one
normal buffer per stored dtype in its served type; each matrix is a view of
it scaled by 1 / sqrt(fan_in), times the spec's factor where it gives one.
Norm scales and running variances are 1, biases, shifts and running means 0,
unless the spec fills a constant of its own. The same seed gives the same values, so
the reference draws its copy again once the program's is freed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_weights(spec: List[Tuple[str, tuple, str, str]], seed: int, device,
                 compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """name -> tensor for every entry of ``refmodel.param_spec``; 'compute'
    entries in ``compute_dtype``, 'f32' in float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dts = {"compute": compute_dtype, "f32": torch.float32}
    out: Dict[str, torch.Tensor] = {}
    for kind in ("compute", "f32"):
        normal = [(n, s, init) for n, s, k, init in spec
                  if k == kind and init.startswith("normal")]
        total = sum(math.prod(s) for _, s, _ in normal)
        buf = torch.randn(total, generator=gen, device=device, dtype=dts[kind])
        at = 0
        for name, shape, init in normal:
            size = math.prod(shape)
            scale = float(init.partition(":")[2] or 1.0)
            w = buf[at:at + size].view(shape)
            w.mul_(scale / math.sqrt(math.prod(shape[1:])))
            out[name] = w
            at += size
    for name, shape, kind, init in spec:
        if not init.startswith("normal"):
            consts = {"one": 1.0, "zero": 0.0}
            fill = consts[init] if init in consts else float(init.partition(":")[2])
            out[name] = torch.full(shape, fill, dtype=dts[kind], device=device)
    return {name: out[name] for name, _, _, _ in spec}
