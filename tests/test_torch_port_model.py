"""The port's model stack against the JAX package: seeded init, the
parameter converter, logits, and greedy ``generate``; plus the port's
package rules (no JAX, no ``bigdl_tpu``, no silent CPU fallback, for
the serving and the training entry points), its export sets against
JAX's in every module both packages have (each JAX name it leaves out
named with its reason), the global config's ``configure`` /
``refresh_from_env`` / ``reload_from_env`` semantics, and ``Remat``
against JAX's."""

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
        "bigdl_tpu_torch.models.train_util, bigdl_tpu_torch.nn.graph, "
        "bigdl_tpu_torch.utils.caffe, bigdl_tpu_torch.models.inception, "
        "bigdl_tpu_torch.models.vgg, bigdl_tpu_torch.obs, "
        "bigdl_tpu_torch.obs.names, bigdl_tpu_torch.obs.metrics, "
        "bigdl_tpu_torch.obs.reqtrace, bigdl_tpu_torch.serving.drain, "
        "bigdl_tpu_torch.serving.classifier, bigdl_tpu_torch.serving.server, "
        "bigdl_tpu_torch.ops.quantized_matmul, bigdl_tpu_torch.nn.quantized, "
        "bigdl_tpu_torch.dlframes, bigdl_tpu_torch.dlframes.dl_estimator, "
        "bigdl_tpu_torch.optim.regularizer, bigdl_tpu_torch.optim.metrics, "
        "bigdl_tpu_torch.dataset.movielens, bigdl_tpu_torch.models.ncf, "
        "bigdl_tpu_torch.models.autoencoder, "
        "bigdl_tpu_torch.examples.ncf_train, bigdl_tpu_torch.dataset.news20, "
        "bigdl_tpu_torch.examples.train_text_cnn, "
        "bigdl_tpu_torch.examples.udf_predict, "
        "bigdl_tpu_torch.obs.trace, bigdl_tpu_torch.obs.server, "
        "bigdl_tpu_torch.serving.spans, bigdl_tpu_torch.serving.placement, "
        "bigdl_tpu_torch.serving.router, bigdl_tpu_torch.serving.rollout, "
        "bigdl_tpu_torch.visualization, "
        "bigdl_tpu_torch.visualization.summary, "
        "bigdl_tpu_torch.dataset.stream, bigdl_tpu_torch.dataset.sample, "
        "bigdl_tpu_torch.dataset.transformer, "
        "bigdl_tpu_torch.utils.bigdl_proto, "
        "bigdl_tpu_torch.resilience.faults, "
        "bigdl_tpu_torch.resilience.elastic, bigdl_tpu_torch.tensor, "
        "bigdl_tpu_torch.nn.layers_extra, bigdl_tpu_torch.nn.volumetric, "
        "bigdl_tpu_torch.nn.sparse, bigdl_tpu_torch.nn.tree_lstm, "
        "bigdl_tpu_torch.models.alexnet, "
        "bigdl_tpu_torch.models.wide_and_deep, "
        "bigdl_tpu_torch.examples.wide_and_deep_train, "
        "bigdl_tpu_torch.examples.train_tree_sentiment, "
        "bigdl_tpu_torch.nn.control_ops, bigdl_tpu_torch.keras, "
        "bigdl_tpu_torch.keras.layers, bigdl_tpu_torch.keras.models, "
        "bigdl_tpu_torch.keras.converter, bigdl_tpu_torch.utils.tf_interop, "
        "bigdl_tpu_torch.utils.tf_records, bigdl_tpu_torch.utils.torch_file, "
        "bigdl_tpu_torch.examples.mnist_cnn, "
        "bigdl_tpu_torch.examples.finetune_frozen_graph, "
        "bigdl_tpu_torch.examples.train_from_tf_pipeline\n"
        "from bigdl_tpu_torch import (Engine, RandomGenerator, config, "
        "configure, Tensor, obs)\n"
        "import bigdl_tpu_torch.analysis.lint, bigdl_torch, "
        "bigdl_torch.nn.layer, bigdl_torch.nn.criterion, "
        "bigdl_torch.nn.keras.layer, bigdl_torch.nn.keras.topology, "
        "bigdl_torch.optim.optimizer, bigdl_torch.util.common, "
        "bigdl_torch.util.tf_utils, bigdl_torch.dataset, "
        "bigdl_torch.dlframes.dl_classifier, bigdl_torch.keras.converter, "
        "bigdl_torch.transform.vision.image, "
        "bigdl_torch.models.lenet.lenet5\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bigdl_tpu' or m.startswith('bigdl_tpu.')"
        " or m == 'bigdl' or m.startswith('bigdl.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_port_source_imports_jax_or_bigdl_tpu():
    """Nor the JAX package's shim ``bigdl``: the port and its own shim
    ``bigdl_torch`` import ``bigdl_tpu_torch`` only."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|bigdl_tpu|bigdl)(\s|\.|$|,)",
        re.M)
    files = sorted((REPO / "bigdl_tpu_torch").rglob("*.py"))
    shim = sorted((REPO / "bigdl_torch").rglob("*.py"))
    assert len(shim) == 23
    files += shim
    files += [REPO / "chip_smoke.py", REPO / "chip_mutants.py",
              REPO / "chip_ab.py",
              REPO / "tests" / "torch_port_distri_worker.py"]
    assert len(files) > 10
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


def test_port_exports_every_jax_criterion_layer_table_op_and_cell():
    """What ``bigdl_tpu.nn`` exports from ``criterion``, ``layers``,
    ``table_ops`` and ``recurrent``, ``bigdl_tpu_torch.nn`` exports
    under the same names."""
    import bigdl_tpu.nn as JN
    import bigdl_tpu_torch.nn as TN

    mods = {f"bigdl_tpu.nn.{m}" for m in ("criterion", "layers",
                                          "table_ops", "recurrent")}
    jax_names = {n for n in JN.__all__
                 if getattr(JN, n).__module__ in mods}
    assert len(jax_names) > 150
    assert sorted(jax_names - set(TN.__all__)) == []
    for n in jax_names:
        assert getattr(TN, n).__name__ == n


def test_port_exports_the_jax_serving_and_obs_surface():
    """What ``bigdl_tpu.serving`` exports, ``bigdl_tpu_torch.serving``
    exports under the same names; of ``bigdl_tpu.obs``, what its metrics
    and trace modules define and the accessors the port has
    (``get_tracer``, ``get_registry``, ``reset``, ``active``)."""
    import bigdl_tpu.obs as JO
    import bigdl_tpu.serving as JS
    import bigdl_tpu_torch.obs as TO
    import bigdl_tpu_torch.serving as TS

    assert len(JS.__all__) >= 26
    assert sorted(set(JS.__all__) - set(TS.__all__)) == []
    for n in JS.__all__:
        t, j = getattr(TS, n), getattr(JS, n)
        if isinstance(j, str):
            assert t == j, n                  # HANDOFF_ERROR's value
        else:
            assert t.__name__.rsplit(".", 1)[-1] == n
    mods = {"bigdl_tpu.obs.metrics", "bigdl_tpu.obs.trace"}
    jax_names = {n for n in JO.__all__
                 if getattr(getattr(JO, n), "__module__", None) in mods
                 or n in ("NULL_TRACER", "DEFAULT_BUCKETS")}
    jax_names |= {"get_tracer", "get_registry", "reset", "active"}
    assert len(jax_names) == 9
    assert sorted(jax_names - set(TO.__all__)) == []


# the slice-14 modules and their JAX counterparts
SLICE14_MODULES = ["visualization", "visualization.summary",
                   "dataset.stream", "dataset.sample", "dataset.transformer",
                   "transform.vision", "utils.bigdl_proto",
                   "resilience.faults"]


def _public(mod) -> set:
    """A module's export set: its ``__all__`` for a package, else the
    public classes and functions it defines."""
    if mod.__name__.split(".")[-1] in ("visualization",):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("name", SLICE14_MODULES)
def test_slice14_export_sets_equal_jax(name):
    import importlib

    j = importlib.import_module(f"bigdl_tpu.{name}")
    t = importlib.import_module(f"bigdl_tpu_torch.{name}")
    want = _public(j)
    assert len(want) >= 3
    assert _public(t) == want
    assert want <= set(t.__all__)
    for n in want:
        assert getattr(t, n).__name__ == n



# ---- the package surface: every module both packages have ---------------------
# JAX names the port leaves out on purpose, and why
LEFT_OUT = {
    # no jit in the port: nothing to trace, cost or sign
    "instrument_jit": "no jit", "hlo_cost_analysis": "no jit",
    "abstract_args": "no jit", "tree_signature": "no jit",
    # DistriOptimizer's wire ring (parallel/wire.py) replaces it
    "int8_blockwise_reduce_scatter": "the wire's ring replaces it",
    # the wire's knobs are TrainConfig's wire_dtype/wire_block/wire_ef
    "WireConfig": "TrainConfig holds the wire's knobs",
}
# JAX names that wait on a later ROADMAP item
WAITING = {
    "item 11": set(),
}


def _exported(mod) -> set:
    """A module's export set: its ``__all__``, else the public classes
    and functions it defines."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == mod.__name__}


def _shared_modules():
    import importlib
    import pkgutil

    import bigdl_tpu_torch

    names = [m.name[len("bigdl_tpu_torch."):] for m in pkgutil.walk_packages(
        bigdl_tpu_torch.__path__, "bigdl_tpu_torch.")]
    out = []
    for name in names:
        try:
            j = importlib.import_module(f"bigdl_tpu.{name}")
        except ImportError:
            continue                      # a module of the port's own
        out.append((name, j, importlib.import_module(
            f"bigdl_tpu_torch.{name}")))
    return out


def test_port_exports_what_jax_exports_in_every_shared_module():
    waiting = set().union(*WAITING.values())
    shared = _shared_modules()
    assert len(shared) > 60
    missing, excused = {}, set()
    for name, j, t in shared:
        want = _exported(j)
        gone = {n for n in want if not hasattr(t, n)}
        excused |= gone & (set(LEFT_OUT) | waiting)
        if gone - set(LEFT_OUT) - waiting:
            missing[name] = sorted(gone - set(LEFT_OUT) - waiting)
    # bigdl_tpu.parallel has no __all__: the names it re-exports from
    # its modules count too
    import inspect

    import bigdl_tpu.parallel as JP
    import bigdl_tpu_torch.parallel as TP

    gone = {n for n, v in vars(JP).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and not hasattr(TP, n)}
    excused |= gone & waiting
    if gone - waiting:
        missing["parallel"] = sorted(gone - waiting)
    assert missing == {}
    # every excuse is still needed: a name the port gains leaves the lists
    assert excused == set(LEFT_OUT) | waiting


def test_the_top_level_exports_jax_names():
    import bigdl_tpu
    import bigdl_tpu_torch

    names = ["Engine", "RandomGenerator", "config", "configure", "Tensor",
             "obs"]
    for n in names:
        assert hasattr(bigdl_tpu, n) and hasattr(bigdl_tpu_torch, n), n
    assert set(names) <= set(bigdl_tpu_torch.__all__)
    assert bigdl_tpu_torch.Tensor.__name__ == "Tensor"
    assert bigdl_tpu_torch.obs.__name__ == "bigdl_tpu_torch.obs"


def test_every_jax_nn_class_but_the_control_ops_is_ported():
    """Every ``bigdl_tpu.nn`` class, the six control ops included (the
    test keeps its name from when they were the ones left)."""
    import bigdl_tpu.nn as JN
    import bigdl_tpu_torch.nn as TN

    assert sorted(set(JN.__all__) - set(TN.__all__)) == []
    for n in ("IfElse", "LoopCondition", "MergeOps", "NextIteration",
              "SwitchOps", "WhileLoop", "DynamicGraph"):
        assert n in TN.__all__
    for n in JN.__all__:
        assert getattr(TN, n).__name__ == n


# ---- the global config ------------------------------------------------------------
@pytest.fixture
def _fresh_config(monkeypatch):
    import importlib

    C = importlib.import_module("bigdl_tpu_torch.config")
    monkeypatch.delenv("BIGDL_TORCH_MAX_NONFINITE_SKIPS", raising=False)
    monkeypatch.delenv("BIGDL_TORCH_SERVE_MAX_BATCH", raising=False)
    C.reload_from_env()
    yield C
    C.reload_from_env()


def test_configure_pins_a_section_and_reaches_every_reader(_fresh_config,
                                                           monkeypatch):
    import dataclasses

    C = _fresh_config
    assert C.TrainConfig.from_env().max_nonfinite_skips == 10
    C.configure(train=dataclasses.replace(C.config.train,
                                          max_nonfinite_skips=3))
    # from_env, which every reader calls, returns the pinned section
    assert C.TrainConfig.from_env().max_nonfinite_skips == 3
    monkeypatch.setenv("BIGDL_TORCH_MAX_NONFINITE_SKIPS", "7")
    monkeypatch.setenv("BIGDL_TORCH_SERVE_MAX_BATCH", "5")
    # a refresh re-reads the environment for the unpinned sections only
    C.refresh_from_env()
    assert C.config.train.max_nonfinite_skips == 3
    assert C.TrainConfig.from_env().max_nonfinite_skips == 3
    assert C.config.serve.max_batch == 5
    assert C.ServeConfig.from_env().max_batch == 5
    # a reload drops the pins
    C.reload_from_env()
    assert C.config.train.max_nonfinite_skips == 7
    assert C.TrainConfig.from_env().max_nonfinite_skips == 7


def test_configure_refuses_an_unknown_field(_fresh_config):
    C = _fresh_config
    with pytest.raises(AttributeError, match="unknown config field "
                       "'no_such'; fields: serve, train, obs"):
        C.configure(no_such=1)
    with pytest.raises(TypeError, match="TrainConfig"):
        C.configure(train=C.ServeConfig())
    assert "train" in C.config.describe()


def test_jax_config_has_the_same_semantics(monkeypatch):
    """The same three steps on JAX's config: a pin survives a refresh,
    a reload drops it, an unknown field raises."""
    import importlib

    JC = importlib.import_module("bigdl_tpu.config")

    monkeypatch.delenv("BIGDL_MAX_NONFINITE_SKIPS", raising=False)
    JC.reload_from_env()
    try:
        JC.configure(max_nonfinite_skips=3)
        monkeypatch.setenv("BIGDL_MAX_NONFINITE_SKIPS", "7")
        JC.refresh_from_env()
        assert JC.config.max_nonfinite_skips == 3
        JC.reload_from_env()
        assert JC.config.max_nonfinite_skips == 7
        with pytest.raises(AttributeError, match="unknown config field"):
            JC.configure(no_such=1)
    finally:
        monkeypatch.delenv("BIGDL_MAX_NONFINITE_SKIPS", raising=False)
        JC.reload_from_env()


# ---- Remat ---------------------------------------------------------------------------
def _remat_pair(with_dropout=False):
    import bigdl_tpu.nn as JN
    import bigdl_tpu_torch.nn as TN

    def build(N):
        inner = N.Sequential().add(N.Linear(6, 8)).add(N.Tanh())
        if with_dropout:
            inner.add(N.Dropout(0.4))
        inner.add(N.Linear(8, 3))
        return N.Sequential().add(N.Linear(5, 6)).add(N.Remat(inner)) \
            .add(N.LogSoftMax())

    JRandom.RNG.set_seed(4)
    jm = build(JN)
    TRandom.RNG.set_seed(4)
    tm = build(TN)
    return jm, tm


def test_remat_gradients_match_jax():
    from torch_port_parity import carry, check_module

    jm, tm = _remat_pair()
    carry(jm, tm)
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    check_module(jm, tm.train(), x, training=True)


def test_remat_recomputes_the_same_dropout_mask():
    """A dropout child under Remat: the backward's recomputed forward
    draws the mask the forward drew, so the gradients equal those of
    the same model without Remat on the same seed."""
    import bigdl_tpu_torch.nn as TN

    _, tm = _remat_pair(with_dropout=True)
    plain = TN.Sequential().add(tm.modules[0]).add(tm.modules[1].modules[0]) \
        .add(tm.modules[2])
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 5).astype(
        np.float32))
    grads = []
    for m in (tm, plain):
        m.train()
        m.zero_grad(set_to_none=True)
        out = m(x, rng_seed=17)
        out.sum().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a different seed draws another mask
    tm.zero_grad(set_to_none=True)
    tm(x, rng_seed=18).sum().backward()
    assert any(not torch.equal(p.grad, g)
               for p, g in zip(tm.parameters(), grads[0]))


def test_remat_refuses_as_jax_does():
    import bigdl_tpu.nn as JN
    import bigdl_tpu_torch.nn as TN

    for N in (JN, TN):
        r = N.Remat(N.Linear(2, 2))
        with pytest.raises(ValueError, match="exactly one module"):
            r.add(N.Linear(2, 2))
        with pytest.raises(ValueError, match="checkpoint_policies"):
            N.Remat(N.Linear(2, 2), policy="no_such_policy")
    with pytest.raises(ValueError, match="no wrapped module"):
        TN.Remat()(torch.zeros(1, 2))


def test_remat_keeps_bn_statistics_of_one_forward():
    import bigdl_tpu_torch.nn as TN

    bn = TN.Sequential().add(TN.BatchNormalization(3))
    wrapped = TN.Remat(TN.Sequential().add(TN.BatchNormalization(3)))
    x = torch.from_numpy(np.random.RandomState(3).randn(6, 3).astype(
        np.float32)).requires_grad_()
    for m in (bn, wrapped):
        m.train()
        m(x).pow(2).sum().backward()
    inner = wrapped.modules[0].modules[0]
    torch.testing.assert_close(inner.running_mean, bn.modules[0].running_mean)
    torch.testing.assert_close(inner.running_var, bn.modules[0].running_var)


def test_echo_prints_the_shape_as_jax(capsys):
    import bigdl_tpu.nn as JN
    import bigdl_tpu_torch.nn as TN

    x = np.zeros((2, 3), np.float32)
    TN.Echo().set_name("e")(torch.from_numpy(x))
    JN.Echo().set_name("e").forward(jnp.asarray(x))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == lines[-1] == "Echo[e]: shape=(2, 3)"


def test_small_names_match_jax(tmp_path):
    import bigdl_tpu.common as JC
    import bigdl_tpu_torch.common as TC
    from bigdl_tpu.utils import serializer as JS
    from bigdl_tpu_torch.optim.optimizer import BaseOptimizer
    from bigdl_tpu_torch.utils import serializer as TS

    t = TC.Table.from_seq(["a", "b"])
    assert t == JC.Table.from_seq(["a", "b"]) and t.to_seq() == ["a", "b"]
    for name in ("float32", "bf16", "double", "int8", None):
        assert str(TC.get_dtype(name)).split(".")[-1] == \
            str(np.dtype(JC.get_dtype(name))).replace("bfloat16", "bfloat16")
    np.testing.assert_array_equal(TC.to_numpy(torch.ones(2)), np.ones(2))
    assert issubclass(LocalOptimizer, BaseOptimizer)

    import bigdl_tpu_torch.nn as TN

    @TS.register_module
    class Doubler(TN.AbstractModule):
        def forward(self, x):
            return 2 * x

    path = TS.save_module(Doubler(), str(tmp_path / "d"))
    assert type(TS.load_module(path)).__name__ == "Doubler"
    assert JS.register_module.__name__ == TS.register_module.__name__
