"""The binary tree-LSTM (Tai et al. 2015) of the port.

Counterpart of ``bigdl_tpu/nn/tree_lstm.py``.  The array encoding is
JAX's: node 0 is the root and every child's index is above its
parent's; ``children`` (B, N, 2) holds the left and right child
indices, -1 on both for a leaf; ``embeddings`` (B, N, D) holds the
leaf word vectors.  JAX runs a reverse ``lax.scan`` over the N nodes
(:69-128) that computes, at each node and for the whole batch, both
the leaf transform (gates i, o, u) and the binary composer (gates i,
f_l, f_r, o, u) and selects per sample.  The port takes every node's
leaf transform in one matmul (it reads no other node), then runs an
eager loop over N − 1 … 0 with the composer and the same selection.
The per-node states are written out of place
(``index_copy``): an in-place write into a buffer autograd saved would
break the backward.  Each node is a few small kernels, so a forward is
bound by launches, not by the card.
"""

from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.nn.module import AbstractModule


class BinaryTreeLSTM(AbstractModule):
    """Input ``(embeddings (B, N, D), children (B, N, 2))`` -> the hidden
    states (B, N, H) of every node, the root at index 0 (JAX :39)."""

    config_names = ("input_size", "hidden_size")

    param_names = ("leaf_w", "leaf_b", "comp_w", "comp_b")

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.reset()

    def reset(self):
        """JAX :52."""
        h, d = self.hidden_size, self.input_size
        s_leaf = 1.0 / np.sqrt(max(1, d))
        s_comp = 1.0 / np.sqrt(max(1, 2 * h))
        rng = RandomGenerator.RNG
        self._set_param("leaf_w", rng.uniform(-s_leaf, s_leaf, (d, 3 * h))
                        .astype(np.float32))
        self._set_param("leaf_b", np.zeros(3 * h, np.float32))
        self._set_param("comp_w", rng.uniform(-s_comp, s_comp,
                                              (2 * h, 5 * h))
                        .astype(np.float32))
        self._set_param("comp_b", np.zeros(5 * h, np.float32))
        return self

    def forward(self, x):
        emb, children = x
        children = torch.as_tensor(children, device=emb.device).long()
        b, n, _ = emb.shape
        hsz = self.hidden_size
        rows = torch.arange(b, device=emb.device)
        slots = torch.arange(n, device=emb.device)
        h_buf = emb.new_zeros((b, n, hsz))
        c_buf = emb.new_zeros((b, n, hsz))
        # per node: a leaf, and the children (clipped, as JAX's) to read
        is_leaf = torch.all(children < 0, dim=-1)             # (B, N)
        safe = torch.clamp(children, 0, n - 1)
        # every node's leaf transform at once: it reads no other node
        lg = emb @ self.leaf_w + self.leaf_b                  # (B, N, 3H)
        li, lo, lu = torch.split(lg, hsz, dim=-1)
        leaf_c = torch.sigmoid(li) * torch.tanh(lu)
        leaf_h = torch.sigmoid(lo) * torch.tanh(leaf_c)
        for i in range(n - 1, -1, -1):
            kid = safe[:, i]
            h_l, h_r = h_buf[rows, kid[:, 0]], h_buf[rows, kid[:, 1]]
            c_l, c_r = c_buf[rows, kid[:, 0]], c_buf[rows, kid[:, 1]]
            gg = torch.cat([h_l, h_r], dim=-1) @ self.comp_w + self.comp_b
            ci, cfl, cfr, co, cu = torch.split(gg, hsz, dim=-1)
            cc = (torch.sigmoid(ci) * torch.tanh(cu)
                  + torch.sigmoid(cfl) * c_l + torch.sigmoid(cfr) * c_r)
            ch = torch.sigmoid(co) * torch.tanh(cc)
            sel = is_leaf[:, i, None]
            at = slots[i:i + 1]
            h_buf = h_buf.index_copy(1, at, torch.where(
                sel, leaf_h[:, i], ch)[:, None])
            c_buf = c_buf.index_copy(1, at, torch.where(
                sel, leaf_c[:, i], cc)[:, None])
        return h_buf


def random_binary_trees(batch: int, n_leaves: int, seed: int = 0):
    """A batch of random full binary tree skeletons in the module's
    encoding (JAX :134): (children (B, N, 2) int32, each sample's sorted
    leaf slots), N = 2·n_leaves − 1.  A subtree of k leaves owns the
    2k − 1 slots from its root on, so children land above parents."""
    rs = np.random.RandomState(seed)
    n = 2 * n_leaves - 1
    children = np.full((batch, n, 2), -1, np.int32)
    leaf_slots = []
    for bi in range(batch):
        leaves = []

        def build(node: int, k: int):
            if k == 1:
                leaves.append(node)
                return
            kl = int(rs.randint(1, k))     # leaves in the left subtree
            left = node + 1
            right = left + (2 * kl - 1)
            children[bi, node] = (left, right)
            build(left, kl)
            build(right, k - kl)

        build(0, n_leaves)
        leaf_slots.append(sorted(leaves))
    return children, leaf_slots


__all__ = ["BinaryTreeLSTM", "random_binary_trees"]
