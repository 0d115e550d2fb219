"""The observability plane at ``Engine.init`` and ``LMEngine``, in both
packages, on the CPU.

With the obs port and the sampling profiler's rate exported
(``BIGDL_OBS_PORT=0``, ``BIGDL_PROF_HZ=50`` and their ``BIGDL_TORCH_*``
twins) and a trace directory set:

- ``Engine.init`` leaves a live ``/healthz`` + ``/metrics`` server and a
  ``SamplingProfiler`` behind, and records the ``engine.init`` complete
  span with its devices, platform and processes;
- an ``LMEngine`` built after the profiler was stopped starts it again;
- with ``check_singleton`` set (``BIGDL_CHECK_SINGLETON`` /
  ``BIGDL_TORCH_CHECK_SINGLETON``) a second ``init`` raises.

Each test shuts the server, the profiler and the engines' state down,
so nothing leaks into the next file of an xdist worker.
"""

import json
import urllib.request

import pytest

from bigdl_tpu import obs as jobs
from bigdl_tpu.config import reload_from_env as jreload
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.obs import prof as JP
from bigdl_tpu.obs import server as jserver
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.config import reload_from_env as treload
from bigdl_tpu_torch.engine import Engine as TEngine
from bigdl_tpu_torch.obs import prof as TP
from bigdl_tpu_torch.obs import server as tserver

_KNOBS = ("OBS_PORT", "PROF_HZ", "TRACE_DIR", "CHECK_SINGLETON",
          "PREEMPTION_HANDLER", "OBS_PORT_FILE")
PACKAGES = {
    "jax": dict(pre="BIGDL_", engine=JEngine, obs=jobs, server=jserver,
                prof=JP, reload=jreload),
    "torch": dict(pre="BIGDL_TORCH_", engine=TEngine, obs=tobs,
                  server=tserver, prof=TP, reload=treload),
}


def _reset_all():
    for p in PACKAGES.values():
        p["engine"].reset()
        p["obs"].reset()
        p["reload"]()


@pytest.fixture(autouse=True)
def _obs_env(tmp_path, monkeypatch):
    for p in PACKAGES.values():
        for k in _KNOBS:
            monkeypatch.delenv(p["pre"] + k, raising=False)
    _reset_all()
    for name, p in PACKAGES.items():
        monkeypatch.setenv(p["pre"] + "OBS_PORT", "0")
        monkeypatch.setenv(p["pre"] + "PROF_HZ", "50")
        monkeypatch.setenv(p["pre"] + "TRACE_DIR", str(tmp_path / name))
        # the signal handlers are process-wide; these tests need none
        monkeypatch.setenv(p["pre"] + "PREEMPTION_HANDLER", "0")
    for p in PACKAGES.values():
        p["reload"]()
    yield
    for p in PACKAGES.values():
        for k in _KNOBS:
            monkeypatch.delenv(p["pre"] + k, raising=False)
    _reset_all()


def _init(name):
    eng = PACKAGES[name]["engine"]
    return eng.init("cpu") if name == "torch" else eng.init()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_init_brings_up_the_server_and_the_profiler(name):
    p = PACKAGES[name]
    assert p["server"].get_server() is None
    _init(name)
    srv = p["server"].get_server()
    assert srv is not None
    status, body = _get(srv.url("/healthz"))
    assert status == 200 and "status" in json.loads(body)
    status, body = _get(srv.url("/metrics"))
    assert status == 200 and "bigdl_engine_inits_total" in body
    assert isinstance(p["prof"].current(), p["prof"].SamplingProfiler)


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_init_records_the_engine_init_span(name):
    p = PACKAGES[name]
    _init(name)
    spans = [r for r in p["obs"].get_tracer().recent()
             if r.get("kind") == "span" and r["name"] == "engine.init"]
    assert len(spans) == 1
    attrs = spans[0]["attrs"]
    assert {"devices", "platform", "processes"} <= set(attrs)
    assert attrs["platform"] == "cpu"
    assert attrs["devices"] >= 1 and attrs["processes"] == 1
    assert spans[0]["dur_s"] >= 0


def _tiny_lm_engine(name):
    if name == "torch":
        from bigdl_tpu_torch.models.transformer import build_transformer_lm
        from bigdl_tpu_torch.serving.engine import LMEngine

        model = build_transformer_lm(64, dim=32, n_head=4, n_layer=2,
                                     max_len=64, device="cpu")
        return LMEngine(model, max_batch=2, page_size=16, device="cpu")
    from bigdl_tpu.models.transformer import build_transformer_lm
    from bigdl_tpu.serving.engine import LMEngine

    model = build_transformer_lm(64, dim=32, n_head=4, n_layer=2,
                                 max_len=64)
    return LMEngine(model, max_batch=2, page_size=16)


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_lm_engine_starts_the_profiler(name):
    p = PACKAGES[name]
    p["prof"].reset_profiler()
    assert not isinstance(p["prof"].current(), p["prof"].SamplingProfiler)
    eng = _tiny_lm_engine(name)
    try:
        assert isinstance(p["prof"].current(), p["prof"].SamplingProfiler)
    finally:
        eng.close()


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_a_second_init_raises_under_check_singleton(name, monkeypatch):
    p = PACKAGES[name]
    _init(name)
    # without the knob a second init is allowed
    _init(name)
    monkeypatch.setenv(p["pre"] + "CHECK_SINGLETON", "1")
    with pytest.raises(RuntimeError, match="CHECK_SINGLETON"):
        _init(name)
