"""Long-context LM training: remat + sequence parallelism.

Counterpart of ``examples/longcontext/train_long_lm.py``.  A
decoder-only ``TransformerLM`` with ``remat=True`` (each block's
forward recomputed in the backward) trains on the JAX example's
synthetic stream (next token = (token + 1) mod vocab, so the loss must
fall) with plain ``w - 0.1·g`` steps, its attention swapped block by
block for ``UlyssesMultiHeadAttention`` on the block's own projections.

The sequence axis is the process world (``Engine``: one process a GPU,
or gloo processes on the CPU), ``--seq-devices`` of it: rank r holds
positions ``[r·T/n, (r+1)·T/n)`` of every sequence.  Where GSPMD hands
the JAX model the whole sequence, a rank here sees its block only, so
the model is told the block's first position (``pos_offset``, read by
the positional embedding); the loss is the mean over every rank's
tokens, so each rank's gradients are summed over the group and divided
by its size.  At one rank all of this is the plain model.

Flags are the JAX example's, with ``--batch`` (its fixed 4),
``--attention`` (``ulysses``, or ``plain``: the block's own
``MultiHeadAttention``, at one rank), ``--dtype`` (``bfloat16`` computes
in bf16 from f32 master weights) and ``--device`` (the card unless
``cpu``) added:

    python -m bigdl_tpu_torch.examples.train_long_lm --seq 4096 --batch 2
    torchrun --nproc_per_node 2 -m bigdl_tpu_torch.examples.train_long_lm \\
        --device cpu
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

log = logging.getLogger("long_lm")


def synthetic_stream(vocab: int, seq: int, batch: int = 4, seed: int = 0):
    """The JAX example's stream: (ids, targets) int64 (batch, seq), each
    row counting up from a random start, mod ``vocab``; the target is
    the next id."""
    rs = np.random.RandomState(seed)
    start = rs.randint(0, vocab, (batch, 1))
    ids = (start + np.arange(seq)[None, :]) % vocab
    return ids.astype(np.int64), ((ids + 1) % vocab).astype(np.int64)


def build_model(args, mesh, device):
    """The remat'd flagship, each block's attention swapped for
    ``UlyssesMultiHeadAttention`` on the block's initialized projections
    (unless ``--attention plain``)."""
    from bigdl_tpu_torch.models.transformer import build_transformer_lm
    from bigdl_tpu_torch.parallel import UlyssesMultiHeadAttention

    model = build_transformer_lm(
        args.vocab, dim=args.dim, n_head=args.heads, n_layer=args.layers,
        max_len=args.seq, remat=True, device=device)
    if args.attention == "plain":
        return model
    for blk in model.blocks():
        attn = UlyssesMultiHeadAttention(args.dim, args.heads, mesh,
                                         seq_axis="seq", causal=True)
        attn.to(model.device)
        attn.set_params(blk.child("attn").params())
        blk._add_child("attn", attn)
    return model


def parse_args(argv=None):
    """The JAX example's flags, with ``--batch``, ``--attention``,
    ``--dtype`` and ``--device`` added."""
    p = argparse.ArgumentParser()
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--seq-devices", type=int, default=None,
                   help="the sequence axis's size (default: the world)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--attention", default="ulysses",
                   choices=("ulysses", "plain"))
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


class LongLMRun:
    """This rank's run: the world's sequence axis, the model, its block
    of the stream, and :meth:`step`, one ``w - 0.1·g`` update that
    returns the group's mean loss."""

    def __init__(self, args, device=None):
        import torch

        from bigdl_tpu_torch.engine import Engine

        Engine.init(device or args.device or "cuda")
        self.device = Engine.device()
        _, world = Engine.world()
        n_seq = args.seq_devices or world
        if n_seq != world:
            raise SystemExit(f"--seq-devices {n_seq} must equal the world "
                             f"size {world}: the sequence axis is the world")
        if args.seq % n_seq:
            raise SystemExit(
                f"--seq {args.seq} must be divisible by the {n_seq}-way "
                "sequence axis")
        if args.heads % n_seq:
            raise SystemExit(
                f"--heads {args.heads} must be divisible by the {n_seq}-way "
                "sequence axis (Ulysses reshards sequence onto heads)")
        if args.attention == "plain" and n_seq > 1:
            raise SystemExit("--attention plain runs at one rank only")
        self.n_seq = n_seq
        self.mesh = Engine.build_mesh({"seq": n_seq})
        t_loc = args.seq // n_seq
        self.offset = self.mesh.index("seq") * t_loc
        log.info("mesh: %d-way sequence parallel, seq=%d (%d tokens/rank)",
                 n_seq, args.seq, t_loc)
        self.model = build_model(args, self.mesh, self.device)
        ids, tgt = synthetic_stream(args.vocab, args.seq, args.batch)
        cut = slice(self.offset, self.offset + t_loc)
        self.x = torch.from_numpy(ids[:, cut]).to(self.device)
        self.y = torch.from_numpy(tgt[:, cut]).to(self.device)
        self.names, self.params = zip(*self.model.named_parameters())
        self.compute_dtype = getattr(torch, args.dtype)

    def _local_loss(self):
        import torch

        ct, off = self.compute_dtype, self.offset
        if ct == torch.float32:
            logits = self.model(self.x, pos_offset=off)
        else:
            cast = {n: q.to(ct) for n, q in zip(self.names, self.params)}
            logits = torch.func.functional_call(
                self.model, cast, (self.x,), {"pos_offset": off})
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(2, self.y[:, :, None]).mean()

    def step(self) -> float:
        import torch
        import torch.distributed as dist

        loss = self._local_loss()
        grads = torch.autograd.grad(loss, self.params)
        loss = loss.detach()
        if self.n_seq > 1:
            flat = torch.cat([torch.cat([g.reshape(-1) for g in grads]),
                              loss.reshape(1)])
            dist.all_reduce(flat, group=self.mesh.group("seq"))
            flat = flat / self.n_seq
            loss = flat[-1]
            grads = torch.split(flat[:-1], [g.numel() for g in grads])
        with torch.no_grad():
            for q, g in zip(self.params, grads):
                q.copy_(q - 0.1 * g.reshape(q.shape))
        return float(loss)             # float(): the step has finished


def main(argv=None, device=None, history=None):
    """Train and return the final loss (the mean over the group).  With
    ``history`` (a dict), fill it with ``losses``, per-step ``seconds``
    and the ``model``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run = LongLMRun(args, device)
    losses, seconds = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        losses.append(run.step())
        seconds.append(time.perf_counter() - t0)
        if i == 0:
            log.info("step 0 loss %.4f (%.1fs)", losses[0], seconds[0])
        elif i % 10 == 0 or i == args.steps - 1:
            log.info("step %d loss %.4f", i, losses[-1])
    first, final = losses[0], losses[-1]
    log.info("loss %.4f -> %.4f over %d steps (seq %d, %d-way "
             "sequence-parallel, remat on)", first, final, args.steps,
             args.seq, run.n_seq)
    if history is not None:
        history.update(losses=losses, seconds=seconds, model=run.model)
    assert final < first, (first, final)
    return final


if __name__ == "__main__":
    main()
