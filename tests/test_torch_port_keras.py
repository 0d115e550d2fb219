"""The port's Keras API against the JAX package's, on the CPU, on the
same weights, within 1e-5 of the largest |JAX value|.

- Every concrete ``KerasLayer`` (42 of them): its ``output_shape``, the
  output shape it really gives, and its forward in eval mode, in a
  one-layer ``Sequential``.
- ``compile``/``fit``/``evaluate``/``predict``/``predict_classes``:
  each step's loss, the evaluation and the predictions; the functional
  ``Model`` wrapper; ``get_weights``/``set_weights``; ``save`` loaded
  by JAX.
- Every test of ``tests/test_keras_converter.py`` (Sequential, merge-
  headed and functional JSON configs, ``load_weights_hdf5`` with the
  recurrent gate orders) runs with ``model_from_json`` and
  ``load_weights_hdf5`` replaced by ones that build and load each model
  in both packages: every prediction of the JAX model is checked
  against the port's, and a config JAX refuses the port refuses too.
"""

import inspect

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.keras as JK
import bigdl_tpu_torch.keras as TK
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.keras import converter as JC
from bigdl_tpu.keras import layers as JL
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.keras import converter as TC
from bigdl_tpu_torch.keras import layers as TL
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

TOL = 1e-5


def _jax_test_module(name):
    """``tests/<name>.py``, the JAX package's test file, loaded as a
    module of its own (its functions are called here, not collected)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).with_name(name + ".py")
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JT = _jax_test_module("test_keras_converter")


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1.0) if want.size else 1.0
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _carry(jm, tm):
    jc, tc = getattr(jm, "core", jm), getattr(tm, "core", tm)
    load_jax_params(tc, jax.tree.map(np.asarray, jc.params()))
    load_jax_state(tc, jax.tree.map(np.asarray, jc.state()))


# (layer, input shape without the batch dim, input kind)
LAYERS = {
    "InputLayer": (lambda K: K.InputLayer(input_shape=(5,)), (5,)),
    "Dense": (lambda K: K.Dense(4, activation="tanh", input_shape=(6,)),
              (6,)),
    "Activation": (lambda K: K.Activation("softmax", input_shape=(5,)),
                   (5,)),
    "Dropout": (lambda K: K.Dropout(0.3, input_shape=(5,)), (5,)),
    "Flatten": (lambda K: K.Flatten(input_shape=(2, 3, 4)), (2, 3, 4)),
    "Reshape": (lambda K: K.Reshape((4, 6), input_shape=(2, 3, 4)),
                (2, 3, 4)),
    "Permute": (lambda K: K.Permute((2, 1), input_shape=(3, 4)), (3, 4)),
    "RepeatVector": (lambda K: K.RepeatVector(3, input_shape=(4,)), (4,)),
    "Convolution2D": (lambda K: K.Convolution2D(
        4, 3, 3, activation="relu", border_mode="same", subsample=(2, 2),
        input_shape=(2, 7, 7)), (2, 7, 7)),
    "MaxPooling2D": (lambda K: K.MaxPooling2D((2, 2), input_shape=(2, 6, 6)),
                     (2, 6, 6)),
    "AveragePooling2D": (lambda K: K.AveragePooling2D(
        (2, 2), strides=(1, 1), input_shape=(2, 5, 5)), (2, 5, 5)),
    "GlobalAveragePooling2D": (lambda K: K.GlobalAveragePooling2D(
        input_shape=(3, 4, 4)), (3, 4, 4)),
    "GlobalMaxPooling2D": (lambda K: K.GlobalMaxPooling2D(
        input_shape=(3, 4, 4)), (3, 4, 4)),
    "ZeroPadding2D": (lambda K: K.ZeroPadding2D((1, 2),
                                                input_shape=(2, 3, 3)),
                      (2, 3, 3)),
    "BatchNormalization": (lambda K: K.BatchNormalization(
        input_shape=(3, 4, 4)), (3, 4, 4)),
    "Embedding": (lambda K: K.Embedding(10, 4, input_length=5), (5,),
                  "ids"),
    "LSTM": (lambda K: K.LSTM(4, return_sequences=True, go_backwards=True,
                              input_shape=(5, 3)), (5, 3)),
    "GRU": (lambda K: K.GRU(4, input_shape=(5, 3)), (5, 3)),
    "SimpleRNN": (lambda K: K.SimpleRNN(4, input_shape=(5, 3)), (5, 3)),
    "Bidirectional": (lambda K: K.Bidirectional(
        K.LSTM(4, return_sequences=True), merge_mode="ave",
        input_shape=(5, 3)), (5, 3)),
    "TimeDistributedDense": (lambda K: K.TimeDistributedDense(
        4, activation="relu", input_shape=(5, 3)), (5, 3)),
    "Convolution1D": (lambda K: K.Convolution1D(
        4, 3, border_mode="same", input_shape=(6, 3)), (6, 3)),
    "MaxPooling1D": (lambda K: K.MaxPooling1D(2, input_shape=(6, 3)),
                     (6, 3)),
    "AveragePooling1D": (lambda K: K.AveragePooling1D(
        3, stride=1, input_shape=(6, 3)), (6, 3)),
    "GlobalMaxPooling1D": (lambda K: K.GlobalMaxPooling1D(
        input_shape=(6, 3)), (6, 3)),
    "GlobalAveragePooling1D": (lambda K: K.GlobalAveragePooling1D(
        input_shape=(6, 3)), (6, 3)),
    "AtrousConvolution2D": (lambda K: K.AtrousConvolution2D(
        3, 3, 3, atrous_rate=(2, 2), border_mode="same",
        input_shape=(2, 9, 9)), (2, 9, 9)),
    "ZeroPadding1D": (lambda K: K.ZeroPadding1D(2, input_shape=(4, 3)),
                      (4, 3)),
    "ZeroPadding3D": (lambda K: K.ZeroPadding3D(
        (1, 0, 2), input_shape=(2, 2, 3, 3)), (2, 2, 3, 3)),
    "Cropping2D": (lambda K: K.Cropping2D(
        ((1, 0), (0, 1)), input_shape=(2, 5, 5)), (2, 5, 5)),
    "UpSampling2D": (lambda K: K.UpSampling2D((2, 3),
                                              input_shape=(2, 3, 3)),
                     (2, 3, 3)),
    "LeakyReLU": (lambda K: K.LeakyReLU(0.2, input_shape=(5,)), (5,)),
    "ELU": (lambda K: K.ELU(0.7, input_shape=(5,)), (5,)),
    "ThresholdedReLU": (lambda K: K.ThresholdedReLU(0.5, input_shape=(5,)),
                        (5,)),
    "Masking": (lambda K: K.Masking(0.0, input_shape=(4, 3)), (4, 3),
                "masked"),
    "GaussianNoise": (lambda K: K.GaussianNoise(0.1, input_shape=(5,)),
                      (5,)),
    "GaussianDropout": (lambda K: K.GaussianDropout(0.3, input_shape=(5,)),
                        (5,)),
    "MaxoutDense": (lambda K: K.MaxoutDense(3, nb_feature=2,
                                            input_shape=(5,)), (5,)),
    "Convolution3D": (lambda K: K.Convolution3D(
        3, 2, 2, 2, activation="tanh", input_shape=(2, 4, 4, 4)),
        (2, 4, 4, 4)),
    "MaxPooling3D": (lambda K: K.MaxPooling3D(
        (2, 2, 2), input_shape=(2, 4, 4, 4)), (2, 4, 4, 4)),
    "AveragePooling3D": (lambda K: K.AveragePooling3D(
        (2, 2, 2), strides=(1, 1, 1), input_shape=(2, 4, 4, 4)),
        (2, 4, 4, 4)),
    "Highway": (lambda K: K.Highway(activation="relu", input_shape=(5,)),
                (5,)),
}


def test_every_keras_layer_is_in_the_table():
    concrete = {n for n, c in vars(JL).items()
                if inspect.isclass(c) and issubclass(c, JL.KerasLayer)
                and c.__module__ == JL.__name__
                and n not in ("KerasLayer", "_KerasRecurrent")}
    assert len(concrete) == 42
    assert concrete == set(LAYERS)
    for n in concrete:
        assert getattr(TL, n).__name__ == n


def _input(shape, kind, rs, n=3):
    if kind == "ids":
        return rs.randint(0, 10, (n,) + shape).astype(np.float32)
    x = rs.randn(n, *shape).astype(np.float32)
    if kind == "masked":
        x[:, 1] = 0.0
    return x


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_shape_and_forward(name):
    make, shape, *kind = LAYERS[name]
    JRandom.RNG.set_seed(5)
    jm = JK.Sequential().add(make(JL))
    TRandom.RNG.set_seed(5)
    tm = TK.Sequential(device="cpu").add(make(TL))
    assert tm.layers[0].output_shape == jm.layers[0].output_shape
    assert tm.output_shape == jm.output_shape
    assert tm.layers[0].compute_output_shape(shape) == \
        jm.layers[0].compute_output_shape(shape)
    _carry(jm, tm)
    x = _input(shape, kind[0] if kind else "float",
               np.random.RandomState(6))
    want = np.asarray(jm.predict(x))
    got = tm.predict(x)
    assert want.shape == (3,) + tuple(jm.layers[0].output_shape)
    _close(got, want)


# ---- the training verbs ------------------------------------------------------
class _Losses:
    def __init__(self):
        self.v = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.v.append(float(value))

    def get_summary_trigger(self, name):
        return None


def _cnn(K, **kw):
    m = K.Sequential(**kw)
    m.add(K.Convolution2D(4, 3, 3, activation="relu", input_shape=(1, 8, 8)))
    m.add(K.MaxPooling2D((2, 2)))
    m.add(K.Flatten())
    m.add(K.Dense(5, activation="softmax"))
    return m


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_compile_fit_evaluate_predict_equal_jax(optimizer, monkeypatch):
    from bigdl_tpu.optim import LocalOptimizer as JLocal
    from bigdl_tpu_torch.optim import LocalOptimizer as TLocal

    JRandom.RNG.set_seed(1)
    jm = _cnn(JK)
    TRandom.RNG.set_seed(1)
    tm = _cnn(TK, device="cpu")
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        np.testing.assert_array_equal(a, b)     # seeded init is JAX's
    rs = np.random.RandomState(0)
    x = rs.randn(64, 1, 8, 8).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 64)]
    recs = {}
    for key, m, cls in (("jax", jm, JLocal), ("torch", tm, TLocal)):
        rec = recs[key] = _Losses()
        real = cls.optimize

        def optimize(self, _rec=rec, _real=real):
            self.set_train_summary(_rec)
            return _real(self)

        monkeypatch.setattr(cls, "optimize", optimize)
        m.compile(optimizer, "categorical_crossentropy", metrics=["acc"])
        m.fit(x, onehot, batch_size=16, nb_epoch=2)
    assert len(recs["torch"].v) == len(recs["jax"].v) == 8
    np.testing.assert_allclose(recs["torch"].v, recs["jax"].v, rtol=TOL)
    np.testing.assert_allclose(tm.evaluate(x, onehot, batch_size=16),
                               jm.evaluate(x, onehot, batch_size=16),
                               rtol=TOL)
    _close(tm.predict(x), np.asarray(jm.predict(x)))
    np.testing.assert_array_equal(tm.predict_classes(x),
                                  np.asarray(jm.predict_classes(x)))
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        _close(b, a)


def test_weights_summary_save_and_model_wrapper(tmp_path, capsys):
    from bigdl_tpu.utils.serializer import load_module as j_load

    JRandom.RNG.set_seed(2)
    jm = _cnn(JK)
    TRandom.RNG.set_seed(2)
    tm = _cnn(TK, device="cpu")
    rs = np.random.RandomState(3)
    new = [rs.randn(*w.shape).astype(np.float32) for w in tm.get_weights()]
    assert tm.set_weights(new) is tm
    jm.set_weights(new)
    for a, b in zip(tm.get_weights(), new):
        np.testing.assert_array_equal(a, b)
    assert tm.summary().splitlines()[2:] == jm.summary().splitlines()[2:]
    capsys.readouterr()
    x = rs.randn(4, 1, 8, 8).astype(np.float32)
    back = j_load(tm.save(str(tmp_path / "k")))
    back.evaluate()
    _close(tm.predict(x), np.asarray(back.forward(x)))
    # the functional wrapper over the same core
    wrapped = TK.Model(tm.core, device="cpu")
    with pytest.raises(TypeError):
        wrapped.add(TL.Dense(2))
    _close(wrapped.predict(x), tm.predict(x))


def test_keras_models_need_the_card_unless_asked_for_the_cpu():
    assert TK.Sequential(device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TK.Sequential()
        with pytest.raises(RuntimeError, match="CUDA"):
            TC.model_from_json(JT.SEQ_JSON)


# ---- the converter ---------------------------------------------------------------
_j_from_json, _j_load_h5 = JC.model_from_json, JC.load_weights_hdf5


class _Dual:
    checks = 0


def _dual_from_json(json_str):
    try:
        jm = _j_from_json(json_str)
    except JC.KerasConversionException:
        with pytest.raises(TC.KerasConversionException):
            TC.model_from_json(json_str, device="cpu")
        raise
    tm = TC.model_from_json(json_str, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    _carry(jm, tm)
    jm._port = tm
    if isinstance(jm, JK.Sequential):
        j_predict = jm.predict

        def predict(x, *a, **k):
            y = j_predict(x, *a, **k)
            _close(tm.predict(x, *a, **k), np.asarray(y))
            _Dual.checks += 1
            return y

        jm.predict = predict
    else:
        j_forward = jm.forward

        def forward(x, *a, **k):
            y = j_forward(x, *a, **k)
            tx = tuple(torch.from_numpy(np.asarray(v)) for v in x) \
                if isinstance(x, tuple) else torch.from_numpy(np.asarray(x))
            tm.evaluate()
            with torch.no_grad():
                _close(tm(tx), np.asarray(y))
            _Dual.checks += 1
            return y

        jm.forward = forward
    return jm


def _dual_load_h5(model, path, by_name=True):
    out = _j_load_h5(model, path, by_name)
    TC.load_weights_hdf5(model._port, path, by_name)
    return out


CONVERTER_TESTS = sorted(n for n, f in vars(JT).items()
                         if n.startswith("test_") and callable(f))


def test_every_converter_test_is_mirrored():
    assert len(CONVERTER_TESTS) == 18


@pytest.mark.parametrize("name", CONVERTER_TESTS)
def test_jax_converter_test_holds_on_the_port(name, monkeypatch, tmp_path):
    monkeypatch.setattr(JT, "model_from_json", _dual_from_json)
    monkeypatch.setattr(JT, "load_weights_hdf5", _dual_load_h5)
    fn = getattr(JT, name)
    kw = {"tmp_path": tmp_path} if "tmp_path" in \
        inspect.signature(fn).parameters else {}
    before = _Dual.checks
    fn(**kw)
    if name not in ("test_unsupported_layer_raises",
                    "test_stateful_recurrent_rejected"):
        assert _Dual.checks > before, "no prediction was compared"
