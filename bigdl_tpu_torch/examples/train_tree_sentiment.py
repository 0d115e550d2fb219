"""Tree-LSTM sentiment on synthetic trees.

Counterpart of ``examples/treelstm/train_tree_sentiment.py``: with no
SST corpus on disk, random binary trees (``synthetic_trees``, the JAX
example's arrays for the same arguments) whose label is the majority
sign of a planted leaf feature.  ``BinaryTreeLSTM`` reads the trees, a
(hidden, 2) matrix scores the root, and the loop is JAX's hand-written
one (``jax.grad`` and an SGD update) in autograd: plain SGD on every
parameter, the loss logged every 50 steps after that step's update,
then ``TreeNNAccuracy`` at the root.  The flags are the JAX example's,
with ``--device`` added (default the card):

    python -m bigdl_tpu_torch.examples.train_tree_sentiment --max-steps 200
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

log = logging.getLogger("treelstm")


def synthetic_trees(batch, n_leaves, dim, seed=7):
    """(embeddings (B, N, D) f32, children (B, N, 2), labels 1/2)."""
    from bigdl_tpu_torch.nn.tree_lstm import random_binary_trees

    children, leaf_slots = random_binary_trees(batch, n_leaves, seed)
    n = 2 * n_leaves - 1
    rs = np.random.RandomState(seed + 1)
    emb = np.zeros((batch, n, dim), np.float32)
    labels = np.zeros((batch,), np.float32)
    for bi, leaves in enumerate(leaf_slots):
        signs = rs.choice([-1.0, 1.0], len(leaves))
        for slot, s in zip(leaves, signs):
            v = rs.randn(dim) * 0.1
            v[0] = s
            emb[bi, slot] = v
        labels[bi] = 1.0 if signs.sum() > 0 else 2.0
    return emb, children, labels


def main(argv=None):
    """Trains; returns ({step: loss} every 50 steps, root accuracy)."""
    import torch

    from bigdl_tpu_torch.common import resolve_device
    from bigdl_tpu_torch.nn import BinaryTreeLSTM
    from bigdl_tpu_torch.optim import TreeNNAccuracy

    ap = argparse.ArgumentParser()
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("--n-leaves", type=int, default=8)
    ap.add_argument("--embed-dim", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--learning-rate", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)

    emb, children, labels = synthetic_trees(
        args.batch_size, args.n_leaves, args.embed_dim)
    m = BinaryTreeLSTM(args.embed_dim, args.hidden).to(dev)
    rs = np.random.RandomState(0)
    w = torch.tensor((rs.randn(args.hidden, 2) * 0.1).astype(np.float32),
                     device=dev, requires_grad=True)
    params = list(m.parameters()) + [w]
    emb_t = torch.from_numpy(emb).to(dev)
    ch_t = torch.from_numpy(children).to(dev)
    y = torch.from_numpy(labels.astype(np.int64) - 1).to(dev)

    def loss_fn():
        h = m((emb_t, ch_t))
        logp = torch.log_softmax(h[:, 0] @ w, dim=-1)
        return -torch.mean(logp.gather(1, y[:, None]))

    lr = args.learning_rate
    losses = {}
    for i in range(args.max_steps):
        grads = torch.autograd.grad(loss_fn(), params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
        if (i + 1) % 50 == 0:
            with torch.no_grad():
                losses[i + 1] = float(loss_fn())
            log.info("step %d loss %.4f", i + 1, losses[i + 1])
    with torch.no_grad():
        logits = (m((emb_t, ch_t))[:, 0] @ w).cpu().numpy()
    acc = TreeNNAccuracy().batch_result(logits[:, None, :], labels)
    log.info("root sentiment accuracy: %.4f", acc.result()[0])
    return losses, acc.result()[0]


if __name__ == "__main__":
    main()
