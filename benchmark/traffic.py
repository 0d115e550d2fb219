"""The one generator of every traffic mix.

A mix is a data file (``workloads/<cell>.json``, key ``traffic``) of
parameters; this module turns it and the run's seed into inputs:
``batch`` rows a step from a pool of ``pool_batches`` batches, made on
the device from the seed and copied to the host once.  Image rows are
N(0, 1) pixels (a normalized image) with labels uniform over the
classes; token rows are ids uniform over the vocabulary, the target the
next id.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchmark import weights

DATA_STREAM = 0xDA7A


def train_pool(mix: dict, config: dict, seed: int, device
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(features, targets) on the host, ``pool_batches * batch`` rows.
    Image targets are 1-based class ids; token targets are the next id,
    1-based (the port's criterion takes 1-based targets)."""
    gen = weights.generator(seed, DATA_STREAM, device)
    rows = int(mix["pool_batches"]) * int(mix["batch"])
    if mix["rows"] == "images":
        size = int(config["image_size"])
        x = torch.randn((rows, 3, size, size), generator=gen, device=device)
        y = torch.randint(1, int(config["num_classes"]) + 1, (rows,),
                          generator=gen, device=device)
        return x.cpu().numpy(), y.to(torch.float32).cpu().numpy()
    if mix["rows"] == "tokens":
        seq = int(mix["seq"])
        ids = torch.randint(0, int(config["vocab_size"]), (rows, seq + 1),
                            generator=gen, device=device, dtype=torch.int64)
        return (ids[:, :seq].to(torch.int32).cpu().numpy(),
                (ids[:, 1:] + 1).to(torch.int32).cpu().numpy())
    raise ValueError(f"unknown rows {mix['rows']!r}")


def tokens_per_row(mix: dict) -> int:
    """Tokens a training row carries (1 for an image row)."""
    return int(mix.get("seq", 1))

