"""``bigdl_tpu/nn/tree_lstm.py`` and the tree-LSTM sentiment example in
the port, on the CPU.

``random_binary_trees`` equal to JAX's; ``BinaryTreeLSTM``'s hidden
states and its parameter and embedding gradients against ``jax.vjp``
of JAX's reverse scan within 1e-5 of the largest |JAX value| (the
integer ``children`` get no gradient); the spec and files across the
packages; the example's synthetic trees equal to JAX's, and its
``main`` (SGD in autograd) logging JAX's losses and root accuracy.
"""

import importlib.util
import logging
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.nn.tree_lstm import random_binary_trees as j_trees
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.examples import train_tree_sentiment as TX
from bigdl_tpu_torch.nn.tree_lstm import random_binary_trees as t_trees

from torch_port_parity import (TOL, carry, check_spec_and_files, rel,
                               to_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("batch,leaves,seed", [(5, 1, 0), (7, 6, 3),
                                               (4, 9, 11)])
def test_random_trees_equal_jax(batch, leaves, seed):
    tc, ts = t_trees(batch, leaves, seed)
    jc, js = j_trees(batch, leaves, seed)
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == jc.dtype and ts == js


def _pair(d=5, h=6, seed=4):
    JRandom.RNG.set_seed(seed)
    jm = JN.BinaryTreeLSTM(d, h)
    TRandom.RNG.set_seed(seed)
    tm = TN.BinaryTreeLSTM(d, h)
    for a, b in zip(tm.params().values(), jm.params().values()):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    return jm, tm


@pytest.mark.parametrize("batch,leaves", [(3, 1), (4, 5), (6, 8)])
def test_forward_and_gradients_match_jax(batch, leaves):
    jm, tm = _pair()
    rs = np.random.RandomState(leaves)
    # off the initial zeros, so the biases' gradients are exercised
    tree = {k: rs.uniform(-1, 1, np.shape(v)).astype(np.float32)
            for k, v in jm.params().items()}
    jm.set_params({k: jnp.asarray(v) for k, v in tree.items()})
    carry(jm, tm)
    children, _ = t_trees(batch, leaves, seed=leaves)
    emb = rs.randn(batch, children.shape[1], 5).astype(np.float32)
    cot = rs.randn(batch, children.shape[1], 6).astype(np.float32)

    def f(p, e):
        return jm.apply(p, {}, (e, jnp.asarray(children)))[0]

    want, vjp = jax.vjp(f, jm.params(), jnp.asarray(emb))
    gp, ge = vjp(jnp.asarray(cot))
    e = torch.from_numpy(emb).requires_grad_()
    got = tm((e, torch.from_numpy(children)))
    assert rel(got, want) <= TOL
    (got * torch.from_numpy(cot)).sum().backward()
    assert rel(e.grad, ge) <= TOL
    for k in tm.param_names:
        assert rel(getattr(tm, k).grad, gp[k]) <= TOL, k


def test_spec_and_files_cross_the_packages(tmp_path):
    jm, tm = _pair()
    check_spec_and_files(jm, tm, str(tmp_path))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_tree_sentiment",
        os.path.join(REPO, "examples", "treelstm", "train_tree_sentiment.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_data_equal_jax():
    JX = _jax_example()
    for a, b in zip(TX.synthetic_trees(6, 5, 4), JX.synthetic_trees(6, 5, 4)):
        np.testing.assert_array_equal(a, b)


def test_example_main_logs_jax_losses_and_accuracy(monkeypatch, caplog):
    """JAX's ``main`` reads ``sys.argv`` and logs its losses to 4
    decimals; the port's returns them: each within the log's rounding
    plus 1e-4 of JAX's, and the same root accuracy."""
    JX = _jax_example()
    argv = ["--max-steps", "100", "-b", "32"]
    monkeypatch.setattr(sys, "argv", ["train_tree_sentiment.py"] + argv)
    JRandom.RNG.set_seed(0)
    with caplog.at_level(logging.INFO, logger="treelstm"):
        JX.main()
    text = caplog.text
    want = {int(s): float(v) for s, v in
            re.findall(r"step (\d+) loss ([0-9.]+)", text)}
    want_acc = float(re.findall(r"accuracy: ([0-9.]+)", text)[-1])
    TRandom.RNG.set_seed(0)
    losses, acc = TX.main(argv + ["--device", "cpu"])
    assert sorted(losses) == sorted(want) == [50, 100]
    for s in want:
        assert abs(losses[s] - want[s]) <= 5e-5 + 1e-4, (s, losses, want)
    assert abs(acc - want_acc) <= 5e-5
