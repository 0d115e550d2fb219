"""The PTB language model: embedding, LSTM, per-step linear head.

Counterpart of ``bigdl_tpu/models/rnn.py``: ``build_ptb_lm`` (:28),
``perplexity`` (:42), ``train_ptb`` (:61) and ``main`` (:87).
``LookupTable`` -> ``Recurrent(LSTM)`` per layer ->
``TimeDistributed(Linear)`` -> ``LogSoftMax``, trained with
``TimeDistributedCriterion(ClassNLLCriterion, size_average=True)``
and the global L2 gradient clip of 5.0, scored by perplexity.  Token
ids are 1-based floats, as the JAX package feeds them.  Run on the card
with ``python -m bigdl_tpu_torch.models.rnn``; with no PTB text on disk
it trains on the synthetic Markov stream.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.nn import (ClassNLLCriterion, Linear, LogSoftMax,
                                LookupTable, LSTM, Recurrent, Sequential,
                                TimeDistributed, TimeDistributedCriterion)

# the reference PTB recipe's global L2 gradient clip
PTB_CLIP_NORM = 5.0


def build_ptb_lm(vocab_size: int, embed_size: int = 128,
                 hidden_size: int = 128, num_layers: int = 1,
                 key_dropout: float = 0.0, device="cuda") -> Sequential:
    """The LM over (B, T) 1-based ids -> (B, T, vocab) log-probabilities,
    drawn from ``RandomGenerator.RNG`` in JAX's order, then moved to
    ``device``."""
    dev = resolve_device(device)
    model = Sequential()
    model.add(LookupTable(vocab_size, embed_size))
    n_in = embed_size
    for _ in range(num_layers):
        model.add(Recurrent().add(LSTM(n_in, hidden_size, p=key_dropout)))
        n_in = hidden_size
    model.add(TimeDistributed(Linear(hidden_size, vocab_size)))
    model.add(LogSoftMax())
    return model.to(dev)


def perplexity(model, x, y, batch_size: int = 32, device="cuda") -> float:
    """exp(mean NLL per token) over the windows ``x`` -> ``y`` in
    eval mode."""
    dev = resolve_device(device)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    model.to(dev).evaluate()
    total, count = 0.0, 0
    with torch.no_grad():
        for b in range(0, x.shape[0], batch_size):
            xb = torch.as_tensor(np.asarray(x[b:b + batch_size]), device=dev)
            yb = torch.as_tensor(np.asarray(y[b:b + batch_size]), device=dev)
            # the criterion's mean over batch and time: NLL per token
            total += float(crit.loss(model(xb), yb)) * xb.shape[0]
            count += xb.shape[0]
    return math.exp(total / max(1, count))


def train_ptb(data_tokens=None, vocab_size: int = 100, batch_size: int = 20,
              num_steps: int = 20, max_epoch: int = 2,
              hidden_size: int = 128, learning_rate: float = 0.5,
              device="cuda"):
    """PTB training (JAX ``train_ptb``): BPTT windows of ``num_steps``
    over ``batch_size`` streams, ``SGD`` with the L2 clip.  Returns
    (model, optimizer, final train perplexity)."""
    from bigdl_tpu_torch.dataset.text import (ptb_bptt_batches,
                                              synthetic_ptb_stream)
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    dev = resolve_device(device)
    if data_tokens is None:
        data_tokens = synthetic_ptb_stream(vocab_size=vocab_size)
    xs, ys = ptb_bptt_batches(data_tokens, batch_size, num_steps)
    x = xs.reshape(-1, num_steps)
    y = ys.reshape(-1, num_steps)
    model = build_ptb_lm(vocab_size, hidden_size=hidden_size,
                         embed_size=hidden_size, device=dev)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    opt = LocalOptimizer(model, (x, y), crit, batch_size=batch_size,
                         device=dev)
    opt.set_optim_method(SGD(learningrate=learning_rate))
    opt.set_end_when(Trigger.max_epoch(max_epoch))
    opt.set_gradient_clipping_by_l2_norm(PTB_CLIP_NORM)
    trained = opt.optimize()
    return trained, opt, perplexity(trained, x, y, batch_size, dev)


def main(argv=None):
    """Console entry: train the PTB LM and print its perplexity."""
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("-b", "--batch-size", type=int, default=20)
    ap.add_argument("-e", "--max-epoch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, ppl = train_ptb(batch_size=args.batch_size,
                          max_epoch=args.max_epoch, device=args.device)
    print(f"final train perplexity: {ppl:.2f}")


if __name__ == "__main__":
    main()
