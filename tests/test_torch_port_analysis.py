"""The port's graftlint (``bigdl_tpu_torch.analysis``) against the JAX
package's, on the CPU.

The CC fixture pairs of ``tests/lint_fixtures/`` give the same (rule,
path, line) findings under both linters.  Port-flavoured RD001-RD008
twins (the port's config knobs, ``obs/names.py`` and
``serving/spans.py``) are written to ``tmp_path``: each bad twin fires
exactly its rule and each clean twin is silent.  Then inline disables,
the baseline's add / drift / expire cycle, the CLI's exit codes and
``--list-rules`` (no JX rule), and the gate: the port's pass over
``bigdl_tpu_torch`` is clean, walks more than 100 files and takes under
20 s.  Last, the fault the pass found: ``get_tracer`` and
``get_collector`` keyed their cache on raw environment reads and missed
a ``configure(obs=...)`` pin, which the JAX package honours."""

import dataclasses
import importlib
import os
import subprocess
import sys
import time

import pytest

from bigdl_tpu.analysis.core import Linter as JLinter
from bigdl_tpu_torch.analysis import core
from bigdl_tpu_torch.analysis.core import (Linter, load_baseline,
                                           write_baseline)
from bigdl_tpu_torch.analysis.lint import main as lint_main
from bigdl_tpu_torch.analysis.lint import run_lint
from bigdl_tpu_torch.analysis.registry_rules import RegistryRules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "lint_fixtures")
CC_STEMS = ["cc001_lock_order", "cc002_unlocked_write", "cc003_bare_acquire"]


def _key(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


@pytest.mark.parametrize("twin", ["bad", "clean"])
@pytest.mark.parametrize("stem", CC_STEMS)
def test_cc_fixtures_give_jax_findings(stem, twin):
    path = os.path.join(FIX, f"{stem}_{twin}.py")
    got = Linter([path], root=REPO).run()
    want = JLinter([path], root=REPO).run()
    assert _key(got) == _key(want)
    if twin == "bad":
        assert got and {f.rule for f in got} == {stem[:5].upper()}
    else:
        assert got == []


# ------------------------------------------------------- RD twins (port)
RD_TWINS = {
    "rd001": ("RD001", False, '''
import os


def attempt():
    return int(os.environ.get("BIGDL_TORCH_NOT_A_FIELD", "0"))


def flag():
    return os.environ["BIGDL_OBS_PORT"]   # the JAX package's knob
''', '''
import os


def attempt():
    return int(os.environ.get("BIGDL_TORCH_ELASTIC_ATTEMPT", "0"))


def export_for_child(env):
    env["BIGDL_TORCH_NOT_A_FIELD_EITHER"] = "1"   # a write: fine
    os.environ["BIGDL_TORCH_OBS_PORT"] = "0"
    return env
'''),
    "rd002": ("RD002", True, '''
import os


def obs_port():
    return os.environ.get("BIGDL_TORCH_OBS_PORT")
''', '''
def obs_port():
    from bigdl_tpu_torch.config import ObsConfig

    return ObsConfig.from_env().obs_port
'''),
    "rd003": ("RD003", False, '''
def publish(reg):
    reg.counter("bigdl_bogus_total", "made up on the spot").inc()


BOGUS_SPELLING = "bigdl_other_bogus_ratio"
''', '''
from bigdl_tpu_torch.obs import names


def publish(reg):
    reg.counter(names.SERVE_TOKENS_TOTAL, "tokens").inc()


def read(parsed_samples):
    return [s for s in parsed_samples
            if s["name"] in ("bigdl_serve_tokens_total",
                             "bigdl_request_latency_seconds_bucket")]
'''),
    "rd005": ("RD005", False, '''
from bigdl_tpu_torch.obs import names


def publish(reg):
    reg.counter(names.SERVE_QUEUE_DEPTH, "x").inc()
    reg.gauge(names.SERVE_BATCH_OCCUPANCY, "x", labels=("engine",))
''', '''
from bigdl_tpu_torch.obs import names


def publish(reg):
    reg.gauge(names.SERVE_QUEUE_DEPTH, "x").set(0)
    reg.counter(names.SERVE_REQUESTS_TOTAL, "x",
                labels=("engine", "status")).labels(
        engine="lm", status="ok").inc()
'''),
    "rd006": ("RD006", False, '''
from bigdl_tpu_torch.serving import spans  # noqa: F401


def route(col, ctx, tracer, t):
    col.span(ctx, "req.placement", t, 0.0, replica="r0")
    tracer.event("serve.admit", slot=1)
''', '''
import re

from bigdl_tpu_torch.serving import spans


def route(col, ctx, tracer, t):
    col.span(ctx, spans.SPAN_PLACEMENT, t, 0.0, replica="r0")
    tracer.event(spans.EVENT_ADMIT, slot=1)
    tracer.complete(spans.SPAN_ROUTE, t, 0.5)


def unrelated(text):
    m = re.search(r"\\d+", text)
    return m.span(0) if m else None
'''),
}

# the registry rules (RD004, RD007, RD008) read a names registry: a mini
# registry in the port's ``_m`` form, with an empty report beside it
_REGISTRY_HEAD = '''
def _m(name, kind, labels=(), cardinality=1, doc="", policy=None):
    return name


'''
REGISTRY_TWINS = {
    "rd004": ("RD004", '''
SILENT = _m("bigdl_torch_fixture_silent_total", "counter")
''', '''
DOCUMENTED = _m("bigdl_torch_fixture_seen_total", "counter",
                doc="documented, so an operator can find it")
'''),
    "rd007": ("RD007", '''
NO_POLICY = _m("bigdl_torch_fixture_depth", "gauge", doc="d")
SUM_RATIO = _m("bigdl_torch_fixture_ratio", "gauge", doc="d",
               policy="sum")
MAX_COUNTER = _m("bigdl_torch_fixture_total", "counter", doc="d",
                 policy="max")
''', '''
DEPTH = _m("bigdl_torch_fixture_depth", "gauge", doc="d", policy="max")
# an additive level: the explicit opt-in
COUNT = _m(  # graftlint: disable=RD007
    "bigdl_torch_fixture_count", "gauge", doc="d", policy="sum")
TOTAL = _m("bigdl_torch_fixture_total", "counter", doc="d")
'''),
    "rd008": ("RD008", '''
PROF = _m("bigdl_prof_fixture_samples_total", "counter", doc="d")
''', '''
PROF = _m("bigdl_prof_fixture_samples_total", "counter", doc="d",
          policy="sum")
'''),
}


def _lint_source(tmp_path, src, lib_mode=False):
    p = tmp_path / "mod.py"
    p.write_text(src)
    return Linter([str(p)], root=str(tmp_path), lib_mode=lib_mode).run()


def _lint_registry(tmp_path, body):
    names = tmp_path / "names.py"
    names.write_text(_REGISTRY_HEAD + body)
    report = tmp_path / "report.py"
    report.write_text("")
    pack = RegistryRules(names_path=str(names), report_path=str(report))
    return Linter([str(names)], root=str(tmp_path), packs=[pack]).run()


@pytest.mark.parametrize("twin", ["bad", "clean"])
@pytest.mark.parametrize("stem", list(RD_TWINS) + list(REGISTRY_TWINS))
def test_port_rd_twins_fire_exactly_their_rule(stem, twin, tmp_path):
    if stem in RD_TWINS:
        rule, lib, bad, clean = RD_TWINS[stem]
        findings = _lint_source(tmp_path, bad if twin == "bad" else clean,
                                lib)
    else:
        rule, bad, clean = REGISTRY_TWINS[stem]
        findings = _lint_registry(tmp_path, bad if twin == "bad" else clean)
    if twin == "clean":
        assert findings == [], "\n".join(f.render() for f in findings)
    else:
        assert findings and {f.rule for f in findings} == {rule}, \
            "\n".join(f.render() for f in findings)
        assert all(f.line > 0 for f in findings)


def test_rd001_declared_knobs_come_from_the_port_config():
    pack = RegistryRules()
    assert "BIGDL_TORCH_OBS_PORT" in pack.declared_env
    assert "BIGDL_OBS_PORT" not in pack.declared_env
    assert pack.names_path.endswith(os.path.join("bigdl_tpu_torch", "obs",
                                                 "names.py"))


# ------------------------------------------------- suppression, baseline
_BARE = open(os.path.join(FIX, "cc003_bare_acquire_bad.py")).read()


def test_inline_disables(tmp_path):
    src = _BARE.replace("_lock.acquire()                  # CC003",
                        "_lock.acquire()  # graftlint: disable=CC003")
    assert _lint_source(tmp_path, src) == []
    wrong = _BARE.replace("_lock.acquire()                  # CC003",
                          "_lock.acquire()  # graftlint: disable=RD003")
    assert [f.rule for f in _lint_source(tmp_path, wrong)] == ["CC003"]
    whole = "# graftlint: disable-file=CC003\n" + _BARE
    assert _lint_source(tmp_path, whole) == []


def test_baseline_add_drift_expire(tmp_path):
    clean = open(os.path.join(FIX, "cc003_bare_acquire_clean.py")).read()
    mod = tmp_path / "legacy.py"
    base = str(tmp_path / "baseline.json")
    mod.write_text(_BARE)
    linter = Linter([str(mod)], root=str(tmp_path))
    found = linter.run()
    assert [f.rule for f in found] == ["CC003"]
    write_baseline(base, found, linter.modules)
    assert run_lint([str(mod)], root=str(tmp_path), baseline=base)[:2] \
        == ([], [])
    mod.write_text("# drift\n# more drift\n" + _BARE)
    assert run_lint([str(mod)], root=str(tmp_path), baseline=base)[:2] \
        == ([], [])
    mod.write_text(_BARE + "\n\ndef more(c, k):\n    _lock.acquire()\n"
                   "    c[k] = 1\n    _lock.release()\n")
    fresh, stale, _ = run_lint([str(mod)], root=str(tmp_path),
                               baseline=base)
    assert [f.rule for f in fresh] == ["CC003"] and stale == []
    mod.write_text(clean)
    fresh, stale, _ = run_lint([str(mod)], root=str(tmp_path),
                               baseline=base)
    assert fresh == [] and len(stale) == 1
    assert lint_main(["--root", str(tmp_path), "--baseline", base,
                      "--write-baseline", str(mod)]) == 0
    assert load_baseline(base) == []


def test_cli_exit_codes_and_rules(capsys):
    assert lint_main(["--root", REPO, "--no-baseline", os.path.join(
        FIX, "cc003_bare_acquire_bad.py")]) == 1
    out = capsys.readouterr().out
    assert "CC003" in out and "cc003_bare_acquire_bad.py:9" in out
    assert lint_main(["--root", REPO, "--no-baseline", os.path.join(
        FIX, "cc003_bare_acquire_clean.py")]) == 0
    capsys.readouterr()
    assert lint_main(["--list-rules"]) == 0
    rules = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert rules == sorted(rules)
    assert {"CC001", "CC002", "CC003", "GL000"} | {
        f"RD00{i}" for i in range(1, 9)} == set(rules)
    assert not any(r.startswith("JX") for r in core.ALL_RULES)


# ------------------------------------------------------------- the gate
def test_the_port_pass_is_clean_and_quick():
    t0 = time.perf_counter()
    fresh, stale, linter = run_lint(root=REPO)
    seconds = time.perf_counter() - t0
    assert fresh == [], "\n".join(f.render() for f in fresh)
    assert stale == []
    assert len(linter.modules) > 100
    assert all(p.startswith("bigdl_tpu_torch/") for p in linter.modules)
    assert seconds < 20.0, seconds


def test_the_cli_module_exits_0_over_the_port():
    proc = subprocess.run([sys.executable, "-m",
                           "bigdl_tpu_torch.analysis.lint"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[graftlint] clean" in proc.stdout


# ------------------------------------------- the fault the pass found
@pytest.fixture
def _obs_clean(monkeypatch):
    from bigdl_tpu_torch import obs

    # the module (the package exports its ``config`` object by that name)
    C = importlib.import_module("bigdl_tpu_torch.config")

    for k in ("BIGDL_TORCH_TRACE_DIR", "BIGDL_TORCH_REQTRACE_SAMPLE",
              "BIGDL_TORCH_REQTRACE_RING"):
        monkeypatch.delenv(k, raising=False)
    C.reload_from_env()
    obs.reset()
    yield C, obs
    C.reload_from_env()
    obs.reset()


def test_a_configure_pin_reaches_the_cached_tracer(_obs_clean, tmp_path):
    C, obs = _obs_clean
    assert obs.get_tracer() is obs.NULL_TRACER      # cached, knob unset
    C.configure(obs=dataclasses.replace(C.ObsConfig.from_env(),
                                        trace_dir=str(tmp_path)))
    tracer = obs.get_tracer()
    assert tracer is not obs.NULL_TRACER
    assert obs.get_tracer() is tracer               # cached again
    C.reload_from_env()
    assert obs.get_tracer() is obs.NULL_TRACER


def test_a_configure_pin_reaches_the_cached_collector(_obs_clean):
    C, _ = _obs_clean
    from bigdl_tpu_torch.obs import reqtrace

    assert reqtrace.get_collector() is reqtrace.NULL_COLLECTOR
    C.configure(obs=dataclasses.replace(C.ObsConfig.from_env(),
                                        reqtrace_sample=1.0))
    assert reqtrace.get_collector() is not reqtrace.NULL_COLLECTOR


def test_the_jax_tracer_honours_a_configure_pin(tmp_path, monkeypatch):
    """The reference behaviour the port now matches."""
    from bigdl_tpu import obs as jobs

    JC = importlib.import_module("bigdl_tpu.config")

    monkeypatch.delenv("BIGDL_TRACE_DIR", raising=False)
    JC.reload_from_env()
    jobs.reset()
    try:
        assert jobs.get_tracer() is jobs.NULL_TRACER
        JC.configure(obs=dataclasses.replace(JC.config.obs,
                                             trace_dir=str(tmp_path)))
        assert jobs.get_tracer() is not jobs.NULL_TRACER
    finally:
        JC.reload_from_env()
        jobs.reset()
