"""Engine: the process's place in the training world.

Counterpart of ``bigdl_tpu/engine.py``: ``Engine.init`` (:36),
``is_initialized``, ``node_number``, ``world()`` and ``build_mesh`` /
``mesh()`` (:184).  The JAX package builds one device mesh for a process
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
installs the preemption handler (``resilience/elastic.py``: SIGTERM or
SIGINT finishes the step in flight, writes an emergency checkpoint and
exits 170) unless ``BIGDL_TORCH_PREEMPTION_HANDLER=0`` (JAX :80-89), and
once the process group is joined records the ``engine.init`` span
(devices, platform, processes) and emits the ``engine.init_barrier``
event the trace merge aligns the ranks' clocks on (JAX :119-133), then
brings up the obs server (``BIGDL_TORCH_OBS_PORT``) and the sampling
profiler (``BIGDL_TORCH_PROF_HZ``) as JAX does (:135-149).  A second
``init`` returns at once, or raises when
``BIGDL_TORCH_CHECK_SINGLETON`` is set (JAX :90-95);
``reset`` drops the injector, a pending preemption request and the
obs server (JAX :175-182), so a test's state does not leak into the
next.

A mesh: the JAX package lays named axes over its devices
(``Engine.build_mesh({"dcn": a, "data": b})``); here each process is
one device, so :meth:`Engine.build_mesh` lays the axes over the
process world, row-major (rank ``= dcn * b + data``), and makes one
``torch.distributed`` group for each line of each axis.  A
``DistriOptimizer`` with ``data_axes=("dcn", "data")`` runs its
exchange over those groups.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from bigdl_tpu_torch.common import resolve_device


class Mesh:
    """Named axes over the process world (``Engine.build_mesh``): rank
    ``r``'s coordinate on axis ``k`` is the k-th digit of ``r`` in the
    row-major mixed radix of ``shape``.  ``group(axis)`` is this
    process's group along ``axis`` (the ranks that differ from it only
    there, in coordinate order), ``index(axis)`` its coordinate."""

    def __init__(self, shape: dict, rank: int, groups: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.rank = rank
        self._groups = groups

    def coords(self, rank: int) -> dict:
        out, rem = {}, rank
        for a in reversed(self.axis_names):
            out[a] = rem % self.shape[a]
            rem //= self.shape[a]
        return out

    def index(self, axis: str) -> int:
        return self.coords(self.rank)[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape})"


class _EngineState:
    initialized = False
    owns_group = False
    device = None
    backend = None
    rank = 0
    world_size = 1
    mesh = None


class Engine:
    _state = _EngineState()

    @classmethod
    def init(cls, device="cuda"):
        """Join (or make) the process group and pick this process's
        device: ``cuda:{LOCAL_RANK}`` under ``torchrun``, else
        ``device`` (the card unless ``"cpu"``; raises without CUDA)."""
        from bigdl_tpu_torch.config import HostConfig, TrainConfig

        if cls._state.initialized:
            if HostConfig.from_env().check_singleton:
                raise RuntimeError(
                    "Engine.init called twice with "
                    "BIGDL_TORCH_CHECK_SINGLETON set; the reference forbids "
                    "two BigDL contexts in one process.")
            return cls
        t_init = time.perf_counter()
        dev = resolve_device(device)
        # a plan exported before init is live before the first trainer
        from bigdl_tpu_torch.resilience.faults import get_injector

        get_injector()
        if TrainConfig.from_env().preemption_handler:
            from bigdl_tpu_torch.resilience.elastic import (
                install_preemption_handler)

            install_preemption_handler()
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
        # the trace merge's alignment anchor (obs/aggregate.py, JAX
        # :127-133): every rank returns from joining the group only once
        # all have joined, so the ranks' clocks align on this event
        from bigdl_tpu_torch import obs
        from bigdl_tpu_torch.obs import names
        from bigdl_tpu_torch.obs import prof as obs_prof
        from bigdl_tpu_torch.obs import server as obs_server

        tracer = obs.get_tracer()
        tracer.complete("engine.init", t_init, time.perf_counter() - t_init,
                        devices=1, platform=dev.type,
                        processes=st.world_size)
        tracer.event("engine.init_barrier", host=st.rank,
                     processes=st.world_size, devices=1)
        obs.get_registry().counter(names.ENGINE_INITS_TOTAL,
                                   "Engine.init calls").inc()
        # the /metrics + /healthz endpoint (BIGDL_TORCH_OBS_PORT) and the
        # sampling profiler (BIGDL_TORCH_PROF_HZ) come up with the engine,
        # before any model or step exists (JAX :135-149); unset, each is
        # one config read and no thread
        obs_server.ensure_server()
        obs_prof.get_profiler()
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
    def build_mesh(cls, mesh_shape: dict):
        """Named axes over the world (``{"dcn": a, "data": b}``, their
        product the world size): a :class:`Mesh`, also kept as
        :meth:`mesh`.  Every rank must call it, in the same order: it
        makes the axes' process groups."""
        rank, world = cls.world()
        shape = {str(k): int(v) for k, v in mesh_shape.items()}
        n = 1
        for v in shape.values():
            n *= v
        if n != world:
            raise ValueError(f"mesh {shape} holds {n} ranks, the world "
                             f"{world}")
        groups = {}
        names = tuple(shape)
        for k, axis in enumerate(names):
            stride = 1
            for a in names[k + 1:]:
                stride *= shape[a]
            # one group per line along `axis`: the ranks whose other
            # coordinates are equal (new_group is collective: every
            # rank makes every group)
            for r0 in range(world):
                if (r0 // stride) % shape[axis]:
                    continue
                ranks = [r0 + i * stride for i in range(shape[axis])]
                g = dist.new_group(ranks) if world > 1 else None
                if rank in ranks:
                    groups[axis] = g
        mesh = Mesh(shape, rank, groups)
        cls._state.mesh = mesh
        return mesh

    @classmethod
    def mesh(cls):
        """The mesh of the last :meth:`build_mesh`, or None."""
        return cls._state.mesh

    @classmethod
    def reset(cls) -> None:
        """Forget the world, destroying the process group if ``init``
        made it, the fault injector's fire-once counters, a pending
        preemption request and the obs server with it."""
        from bigdl_tpu_torch.obs import server as obs_server
        from bigdl_tpu_torch.resilience.elastic import clear_preemption
        from bigdl_tpu_torch.resilience.faults import reset_injector

        reset_injector()
        clear_preemption()
        obs_server.stop_server()
        if cls._state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        cls._state = _EngineState()


__all__ = ["Engine", "Mesh"]
