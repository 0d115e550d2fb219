"""The port's model stack against the JAX package: seeded init, the
parameter converter, logits, and greedy ``generate``; plus the port's
package rules (no JAX, no ``bigdl_tpu``, no silent CPU fallback, for
the serving and the training entry points)."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.models.resnet import (build_resnet_cifar,
                                           build_resnet_imagenet)
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_build
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.optim import LocalOptimizer
from bigdl_tpu_torch.utils.convert import load_jax_params, params_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(dim=32, n_head=4, n_layer=2, max_len=64)
# the JAX model's attention next to the port's
IMPLS = {"reference": "lax", "kernel": "pallas"}


def _jax_model(impl="kernel", seed=13):
    JRandom.RNG.set_seed(seed)
    return j_build(48, attn_impl=IMPLS[impl], **SMALL)


def _port_model(impl="kernel", seed=13):
    TRandom.RNG.set_seed(seed)
    return t_build(48, attn_impl=impl, device="cpu", **SMALL)


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _walk(a, b, path=""):
    """Assert two nested dicts hold the same keys and equal arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _walk(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(
            np.asarray(a), b.detach().numpy(), err_msg=path)


def test_seeded_init_draws_the_jax_numbers():
    _walk(_numpy_tree(_jax_model().params()), _port_model().params())


def test_params_from_jax_round_trip():
    tree = _numpy_tree(_jax_model(seed=5).params())
    conv = params_from_jax(tree)
    assert set(conv["h0"]["attn"]) == {"wq", "wk", "wv", "wo",
                                       "bq", "bk", "bv", "bo"}
    assert set(conv["head"]) == {"weight"}   # the head has no bias
    model = _port_model(seed=99)
    load_jax_params(model, tree)
    _walk(tree, model.params())
    # and back: the port's params as numpy load into a third model
    def to_numpy(t):
        if isinstance(t, dict):
            return {k: to_numpy(v) for k, v in t.items()}
        return t.detach().numpy()

    again = _port_model(seed=3)
    load_jax_params(again, to_numpy(model.params()))
    _walk(tree, again.params())


def test_load_rejects_an_incomplete_tree():
    tree = _numpy_tree(_jax_model().params())
    del tree["ln_f"]
    with pytest.raises(KeyError, match="ln_f"):
        load_jax_params(_port_model(), tree)


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_logits_match_jax_apply(impl):
    jm = _jax_model(impl)
    tm = _port_model(impl, seed=77)
    load_jax_params(tm, _numpy_tree(jm.params()))
    x = np.random.RandomState(0).randint(0, 48, (2, 16))
    want = np.asarray(jm.apply(jm.params(), {}, jnp.asarray(x))[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_generate_tokens_equal_jax_generate():
    jm = _jax_model("kernel", seed=21)
    tm = _port_model("kernel", seed=21)
    rs = np.random.RandomState(4)
    for t0, n in ((8, 12), (5, 9)):
        prompt = rs.randint(0, 48, (2, t0))
        want = np.asarray(jm.generate(jm.params(), prompt, n))
        got = tm.generate(prompt, n)
        assert got.dtype == torch.int32 and tuple(got.shape) == (2, t0 + n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_generate_argument_checks():
    tm = _port_model()
    with pytest.raises(ValueError, match="max_len"):
        tm.generate(np.zeros((1, 60), np.int32), 10)
    with pytest.raises(ValueError, match="Generator"):
        tm.generate(np.zeros((1, 4), np.int32), 2, temperature=1.0)
    gen = torch.Generator().manual_seed(0)
    out = tm.generate(np.zeros((1, 4), np.int32), 3, temperature=1.0,
                      generator=gen)
    assert tuple(out.shape) == (1, 7) and int(out.max()) < 48


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_build(48, **SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_resnet_imagenet(depth=50, class_num=10)
    model = build_resnet_cifar(20, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalOptimizer(model, (np.zeros((4, 3, 32, 32), np.float32),
                               np.ones(4, np.float32)),
                       CrossEntropyCriterion(), batch_size=4)
    assert resolve_device("cpu") == torch.device("cpu")


def test_import_loads_neither_jax_nor_bigdl_tpu():
    code = (
        "import sys\n"
        "import bigdl_tpu_torch, bigdl_tpu_torch.common, "
        "bigdl_tpu_torch.config, bigdl_tpu_torch.nn, bigdl_tpu_torch.ops, "
        "bigdl_tpu_torch.ops._cuda, bigdl_tpu_torch.models, "
        "bigdl_tpu_torch.serving, bigdl_tpu_torch.utils.convert, "
        "bigdl_tpu_torch.optim, bigdl_tpu_torch.optim.optimizer, "
        "bigdl_tpu_torch.dataset, bigdl_tpu_torch.models.resnet, "
        "bigdl_tpu_torch.nn.fused, bigdl_tpu_torch.nn.criterion, "
        "bigdl_tpu_torch.nn.table_ops, bigdl_tpu_torch.ops.conv_bn, "
        "bigdl_tpu_torch.nn.recurrent, bigdl_tpu_torch.models.rnn, "
        "bigdl_tpu_torch.models.lenet, bigdl_tpu_torch.optim.validation, "
        "bigdl_tpu_torch.optim.evaluator, bigdl_tpu_torch.dataset.text, "
        "bigdl_tpu_torch.dataset.mnist, bigdl_tpu_torch.engine, "
        "bigdl_tpu_torch.optim.distri_optimizer, "
        "bigdl_tpu_torch.optim.optim_method, bigdl_tpu_torch.resilience, "
        "bigdl_tpu_torch.resilience.retry, bigdl_tpu_torch.utils.serializer, "
        "bigdl_tpu_torch.utils.tree, bigdl_tpu_torch.transform.vision, "
        "bigdl_tpu_torch.dataset.imagenet, bigdl_tpu_torch.dataset.prefetch, "
        "bigdl_tpu_torch.models.train_util\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bigdl_tpu' or m.startswith('bigdl_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_port_source_imports_jax_or_bigdl_tpu():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|bigdl_tpu)(\s|\.|$|,)", re.M)
    files = sorted((REPO / "bigdl_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "chip_mutants.py",
              REPO / "tests" / "torch_port_distri_worker.py"]
    assert len(files) > 10
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"
