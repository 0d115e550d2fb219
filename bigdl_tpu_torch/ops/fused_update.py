"""The optimizer update over every parameter tensor at once: the clip,
Adam, the non-finite guard and the write-back in two launches a step.

No TPU kernel is replaced: the JAX package's update (``Adam.step``, the
clipper and the guard of ``bigdl_tpu/optim/optimizer.py``) runs inside
the jitted step, where XLA fuses it.  Run eagerly a tensor at a time it
costs ~27 launches a tensor and ~50 passes over memory; on a CUDA tensor
:func:`adam_update` launches the hand-written ``csrc/fused_adam.cu``
instead (:class:`KernelAdamUpdate`):

* pass 1 (``stats``) reads every gradient once, with the
  constant clip applied, and leaves on the device the global L2 clip's
  scale and ``ok`` (every clipped gradient and the loss finite);
* pass 2 (``apply``) reads g, m, v and p once and, where
  ``ok`` holds (or always, without the guard), writes m, v and p in
  place; a frozen tensor's m and v step and its p is kept.

The update is bound by device-memory bytes: 32 B an element over both
passes, 13.0 GB for GPT-2-medium's 406.3M values, 3.9 ms at 3.35 TB/s.
The kernel reads m, v and p once and g twice, with 16-byte accesses.

Each element takes ``_GradClipper``'s and ``Adam.step``'s operations in
their order, rounded one at a time, with ``lr``, ``bc1`` and ``bc2``
given as the device tensors the same torch ops made, so given the same
clip scale it is bit-equal to the per-tensor path; the norm is summed
in another (fixed) order.  :class:`PlainAdamUpdate` is the same in-place
function in torch ops, op for op as the per-tensor path; the wrapper
takes it for CPU tensors only, and a CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.ops import _cuda

# elements of a chunk, the unit a block takes (csrc/fused_adam.cu CHUNK)
CHUNK = 4096
# blocks of the kernels' grid on each streaming multiprocessor
BLOCKS_PER_SM = 4
# the call's flags and an entry's flags (csrc/fused_adam.cu)
CONST_CLIP, L2_CLIP, GATE = 1, 2, 4
FROZEN, ALIGNED = 1, 2
# int64 words of the buffer's header and of one table entry
HEADER_WORDS = ENTRY_WORDS = 8
# byte of the header that holds ok
OK_BYTE = 8


def takes(params: Sequence[torch.Tensor], *state) -> bool:
    """Can :func:`adam_update` update ``params`` (and the lists of
    ``state``, m and v, as many values each) in place: f32 contiguous
    tensors, all on one device."""
    if not params or any(len(s) != len(params) for s in state):
        return False
    dev, f32 = params[0].device, torch.float32
    for ts in (params, *state):
        for t in ts:
            if t.dtype is not f32 or not t.is_contiguous() or \
                    t.device != dev:
                return False
    return all(len({t.numel() for t in group}) == 1
               for group in zip(params, *state)) if state else True


class PlainAdamUpdate:
    """The update in torch ops, any device: ``_GradClipper``, then
    ``Adam.step`` and the guard's ``where``, op for op, each result
    copied into p, m and v."""

    def __init__(self, grads, params, m, v, frozen, l2_clip=None,
                 const_clip=None):
        self.grads, self.params, self.m, self.v = grads, params, m, v
        self.frozen = list(frozen) or [False] * len(params)
        self.l2_clip, self.const_clip = l2_clip, const_clip
        self.ok: Optional[torch.Tensor] = None
        self._clipped = None

    def _clip(self):
        g = self.grads
        if self.const_clip is not None:
            lo, hi = self.const_clip
            g = [torch.clamp(a, lo, hi) for a in g]
        if self.l2_clip is not None:
            sq = sum(torch.sum(a * a) for a in g)
            scale = torch.clamp_max(self.l2_clip / (torch.sqrt(sq) + 1e-12),
                                    1.0)
            g = [a * scale for a in g]
        return g

    def stats(self, loss) -> torch.Tensor:
        """Keeps the clipped gradients; returns ``ok`` (a 0-d bool)."""
        g = self._clipped = self._clip()
        ok = torch.isfinite(loss)
        for a in g:
            ok = ok & torch.isfinite(a).all()
        self.ok = ok
        return ok

    @torch.no_grad()
    def apply(self, lr, bc1, bc2, *, beta1: float, beta2: float,
              eps: float, gate: bool) -> None:
        """m, v and p (not a frozen one's) stepped in place; with
        ``gate``, only where :meth:`stats`' ``ok`` holds."""
        if gate and self.ok is None:
            raise ValueError("apply(gate=True) needs stats() first")
        g = self._clipped if self._clipped is not None else self._clip()
        b1, b2 = beta1, beta2
        for a, p, m, v, f in zip(g, self.params, self.m, self.v,
                                 self.frozen):
            m_new = b1 * m + (1 - b1) * a
            v_new = b2 * v + (1 - b2) * a * a
            p_new = p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if gate:
                m_new = torch.where(self.ok, m_new, m)
                v_new = torch.where(self.ok, v_new, v)
                p_new = torch.where(self.ok, p_new, p)
            m.copy_(m_new)
            v.copy_(v_new)
            if not f:
                p.copy_(p_new)


@functools.lru_cache(maxsize=None)
def _grid_cap(index: int) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * BLOCKS_PER_SM


def _ptrs(tensors) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in tensors), np.int64,
                       len(tensors))


class KernelAdamUpdate:
    """:class:`PlainAdamUpdate`'s function through
    ``csrc/fused_adam.cu``: the table of every tensor's pointers goes to
    the device once, then pass 1 and pass 2 launch on the current
    stream.  Raises on tensors the kernel does not take."""

    def __init__(self, grads, params, m, v, frozen, l2_clip=None,
                 const_clip=None):
        if not takes(params, m, v) or params[0].device.type != "cuda":
            raise ValueError("fused_adam kernel takes f32 contiguous p, m "
                             "and v of one size each, on one card")
        dev = params[0].device
        if len(grads) != len(params):
            raise ValueError("fused_adam kernel: one gradient a parameter")
        for g, p in zip(grads, params):
            if g.dtype is not torch.float32 or g.device != dev or \
                    g.numel() != p.numel():
                raise ValueError(f"fused_adam kernel takes f32 gradients "
                                 f"the size of p on {dev}, got {g.dtype} "
                                 f"{tuple(g.shape)} on {g.device}")
        # the gradients are only read: a strided one is copied
        self.grads = [g if g.is_contiguous() else g.contiguous()
                      for g in grads]
        self.device = dev
        self.l2_clip, self.const_clip = l2_clip, const_clip
        self.ok: Optional[torch.Tensor] = None
        n = len(params)
        numel = np.fromiter((p.numel() for p in params), np.int64, n)
        chunks = -(-numel // CHUNK)
        self.n_tensors = n
        self.n_chunks = int(chunks.sum())
        self.grid = min(_grid_cap(dev.index if dev.index is not None
                                  else torch.cuda.current_device()),
                        max(1, self.n_chunks))
        words = HEADER_WORDS + ENTRY_WORDS * n
        host = torch.zeros(words, dtype=torch.int64, pin_memory=True)
        table = host.numpy()[HEADER_WORDS:].reshape(n, ENTRY_WORDS)
        table[:, 0] = _ptrs(self.grads)
        table[:, 1] = _ptrs(params)
        table[:, 2] = _ptrs(m)
        table[:, 3] = _ptrs(v)
        table[:, 4] = numel
        table[:, 5] = np.cumsum(chunks) - chunks
        aligned = ((table[:, 0] | table[:, 1] | table[:, 2] | table[:, 3])
                   % 16) == 0
        frozen = np.zeros(n, bool) if not any(frozen) else \
            np.asarray(frozen, bool)
        table[:, 6] = np.where(frozen, FROZEN, 0) | np.where(aligned,
                                                             ALIGNED, 0)
        # header and table, then the grid's f32 partials and i32 flags
        self.buf = torch.empty(words + self.grid, dtype=torch.int64,
                               device=dev)
        self.buf[:words].copy_(host, non_blocking=True)

    def _flags(self) -> int:
        return ((CONST_CLIP if self.const_clip is not None else 0)
                | (L2_CLIP if self.l2_clip is not None else 0))

    def _launch(self, pass_, loss=None, lr=None, bc1=None, bc2=None,
                coef=(0.0,) * 5, gate=False) -> None:
        lo, hi = self.const_clip if self.const_clip is not None else (0, 0)
        clip = self.l2_clip if self.l2_clip is not None else 0.0
        flags = self._flags() | (GATE if gate else 0)
        _cuda.launch_fused_adam(pass_, self.buf, self.n_tensors,
                                self.n_chunks, self.grid, loss, lr, bc1, bc2,
                                *coef, clip, lo, hi, flags)

    def stats(self, loss) -> torch.Tensor:
        """Pass 1; returns ``ok``, a 0-d bool view of the buffer."""
        loss = _scalar(loss, self.device)
        self._launch(1, loss=loss)
        self.ok = self.buf.view(torch.uint8)[OK_BYTE].view(torch.bool)
        return self.ok

    def apply(self, lr, bc1, bc2, *, beta1: float, beta2: float,
              eps: float, gate: bool) -> None:
        """Pass 2, after :meth:`stats` when a clip is set or ``gate``."""
        if (gate or self.l2_clip is not None) and self.ok is None:
            raise ValueError("apply() with a clip or gate needs stats() "
                             "first")
        lr, bc1, bc2 = (_scalar(x, self.device) for x in (lr, bc1, bc2))
        self._launch(2, lr=lr, bc1=bc1, bc2=bc2,
                     coef=(beta1, 1 - beta1, beta2, 1 - beta2, eps),
                     gate=gate)


def _scalar(x, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device`` (the kernel reads it there)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.dim() != 0:
        raise ValueError(f"fused_adam kernel takes 0-d scalars, got shape "
                         f"{tuple(x.shape)}")
    return x


def adam_update(grads, params, m, v, frozen=(), l2_clip=None,
                const_clip=None):
    """One step's update of ``params``, ``m`` and ``v`` in place: the
    plain version for CPU tensors, else the kernel."""
    cls = PlainAdamUpdate if params[0].device.type == "cpu" \
        else KernelAdamUpdate
    return cls(grads, params, m, v, frozen, l2_clip, const_clip)


__all__ = ["takes", "adam_update", "PlainAdamUpdate", "KernelAdamUpdate",
           "CHUNK"]
