"""Weights made from the run's seed, on the device, in a few large calls.

A configuration's plain reference lists its parameters as
``(name, shape, init)``; ``init`` is ``("normal", std)``, ``("ones",)``
or ``("zeros",)``.  Every normal parameter is cut from one draw of a
``torch.Generator`` on the device, so the same seed gives the same
weights on the same device, and the reference gets them again by
calling :func:`make` once more after the program is gone.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# the generator's seed of the weights, apart from the traffic's
WEIGHT_STREAM = 0x5EED


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from the run's seed and a stream
    number, so that weights, data and prompts draw apart."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return gen


def make(specs: List[Tuple[str, tuple, tuple]], seed: int, device,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``specs``: one ``randn`` over every normal
    element, sliced and scaled; ones and zeros filled."""
    gen = generator(seed, WEIGHT_STREAM, device)
    sizes = [torch.Size(shape).numel() for _, shape, init in specs
             if init[0] == "normal"]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in specs:
        if init[0] == "normal":
            n = torch.Size(shape).numel()
            out[name] = (flat[at:at + n].view(shape) * init[1]).to(dtype)
            at += n
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out
