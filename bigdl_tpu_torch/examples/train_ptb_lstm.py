"""PTB language model: an LSTM trained over BPTT windows.

Counterpart of ``examples/ptb/train_ptb_lstm.py``: ``models.rnn.train_ptb``
(an embedding, an LSTM and a time-distributed linear + log-softmax, SGD
with the L2 gradient clip) on the synthetic Markov token stream when no
PTB file is given, or on a tokenised text file through a
``Dictionary``; it prints the final train perplexity.  The flags are
the JAX example's, with ``--device`` added (default the card):

    python -m bigdl_tpu_torch.examples.train_ptb_lstm --max-epoch 2
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    """Train as the JAX example does; returns the final perplexity."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None, help="tokenised PTB text file")
    ap.add_argument("-b", "--batch-size", type=int, default=20)
    ap.add_argument("--num-steps", type=int, default=20)
    ap.add_argument("-e", "--max-epoch", type=int, default=2)
    ap.add_argument("--learning-rate", type=float, default=0.5)
    ap.add_argument("--vocab-size", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from bigdl_tpu_torch.dataset.text import Dictionary
    from bigdl_tpu_torch.models.rnn import train_ptb

    tokens = None
    vocab_size = args.vocab_size
    if args.data:
        with open(args.data) as f:
            words = f.read().split()
        d = Dictionary([words], vocab_size=args.vocab_size)
        import numpy as np

        tokens = np.asarray([d.get_index(w) for w in words], np.int64)
        vocab_size = d.vocab_size()
    _model, _opt, ppl = train_ptb(
        data_tokens=tokens,
        vocab_size=vocab_size,
        batch_size=args.batch_size,
        num_steps=args.num_steps,
        max_epoch=args.max_epoch,
        learning_rate=args.learning_rate,
        device=args.device,
    )
    print(f"final perplexity: {ppl:.2f}")
    return ppl


if __name__ == "__main__":
    main()
