"""Engine: the process's place in the training world.

Counterpart of ``bigdl_tpu/engine.py``: ``Engine.init`` (:36),
``is_initialized``, ``node_number`` and, in place of ``mesh()``,
``world()``.  The JAX package builds one device mesh for a process
that drives every chip; the port runs one process per GPU, so the world
is a ``torch.distributed`` process group:

- a process group the caller already made is adopted as it is;
- under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
  ``MASTER_ADDR``/``MASTER_PORT`` in the environment) the process joins
  that group on ``cuda:{LOCAL_RANK}``;
- otherwise it makes a world of 1 over an in-process ``HashStore``,
  which opens no port.

The backend is NCCL on the card and gloo on the CPU.  ``init`` builds
the fault injector from ``BIGDL_TORCH_FAULT_PLAN`` (JAX :77-79) and
``reset`` drops it (JAX :179), so a test's plan does not leak into the
next.  The preemption handler and observability of the JAX
``Engine.init`` are not ported yet (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from bigdl_tpu_torch.common import resolve_device


class _EngineState:
    initialized = False
    owns_group = False
    device = None
    backend = None
    rank = 0
    world_size = 1


class Engine:
    _state = _EngineState()

    @classmethod
    def init(cls, device="cuda"):
        """Join (or make) the process group and pick this process's
        device: ``cuda:{LOCAL_RANK}`` under ``torchrun``, else
        ``device`` (the card unless ``"cpu"``; raises without CUDA)."""
        if cls._state.initialized:
            return cls
        dev = resolve_device(device)
        # a plan exported before init is live before the first trainer
        from bigdl_tpu_torch.resilience.faults import get_injector

        get_injector()
        env = os.environ
        if dev.type == "cuda" and "LOCAL_RANK" in env:
            dev = torch.device("cuda", int(env["LOCAL_RANK"]))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        st = _EngineState()
        if dist.is_initialized():
            backend = dist.get_backend()
        elif "RANK" in env and "WORLD_SIZE" in env:
            dist.init_process_group(backend, init_method="env://",
                                    rank=int(env["RANK"]),
                                    world_size=int(env["WORLD_SIZE"]))
            st.owns_group = True
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
            st.owns_group = True
        st.initialized = True
        st.device = dev
        st.backend = backend
        st.rank = dist.get_rank()
        st.world_size = dist.get_world_size()
        cls._state = st
        return cls

    @classmethod
    def is_initialized(cls) -> bool:
        return cls._state.initialized

    @classmethod
    def node_number(cls) -> int:
        """The number of processes (one GPU each) in the world."""
        return cls._state.world_size

    @classmethod
    def world(cls):
        """(rank, world size); initializes a world of 1 on first use."""
        if not cls._state.initialized:
            cls.init()
        return cls._state.rank, cls._state.world_size

    @classmethod
    def device(cls) -> torch.device:
        if not cls._state.initialized:
            cls.init()
        return cls._state.device

    @classmethod
    def reset(cls) -> None:
        """Forget the world, destroying the process group if ``init``
        made it, and the fault injector's fire-once counters with it."""
        from bigdl_tpu_torch.resilience.faults import reset_injector

        reset_injector()
        if cls._state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        cls._state = _EngineState()


__all__ = ["Engine"]
