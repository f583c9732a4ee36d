"""Random streams of a run, derived from (seed, step, name).

The port's counterpart of ``evoke_tpu/core/prng.py``: one root seed per run,
folded per purpose and per step, so a stream is a pure function of its
(seed, step, name) and a resumed run draws exactly what an unbroken run
would have drawn. JAX folds keys; here the three are hashed into the seed of
an explicit ``torch.Generator`` on the device that draws from it.
"""

from __future__ import annotations

import hashlib

import torch


def _name_to_int(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def stream_seed(seed: int, step: int, name: str = "step") -> int:
    """A 63-bit generator seed for (seed, step, name)."""
    blob = f"{int(seed)}:{int(step)}:{_name_to_int(name)}".encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "little") >> 1


def step_generator(seed: int, step: int, name: str = "step", device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from (seed, step, name)."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, step, name))
    return g
