"""graftlint RD rules: config and metric registry drift.

The port's own registries, as the JAX package's rules
(``bigdl_tpu/analysis/registry_rules.py``) hold that package's.  Two
registries anchor the operational surface: ``bigdl_tpu_torch/config.py``
declares every ``BIGDL_*`` environment variable the port honours (its
``BIGDL_TORCH_*`` knobs, through its ``_env_*`` helpers),
and ``bigdl_tpu_torch/obs/names.py`` declares every published ``bigdl_*``
metric family.  Drift — a module minting its own env spelling or metric
name — is invisible until a dashboard quietly reads zeros.  These rules
pin both registries closed:

* **RD001 undeclared-env-read** — a ``BIGDL_*`` env var is read
  (``os.environ[...]`` / ``.get`` / ``os.getenv``) but not declared in
  ``config.py``.  Harness bootstrap vars (``config.HARNESS_ENV``) are
  allowed in scripts only.
* **RD002 raw-env-read-in-library** — framework code outside
  ``config.py`` reads a ``BIGDL_*`` var from the environment directly
  instead of through the config object; the read bypasses
  ``configure()`` overrides and the documented resolution order.
* **RD003 unregistered-metric-name** — a ``bigdl_*`` name is minted or
  spelled without a declaration in ``obs/names.py`` (histogram
  ``_bucket``/``_sum``/``_count`` derivations and the declared
  ``KNOWN_STRINGS`` non-metric spellings are fine); library mint sites
  must use the names constants, not literals.
* **RD004 unrendered-undocumented-metric** — a declared metric is
  neither rendered by ``obs/report.py`` nor documented in its spec.
* **RD005 metric-shape-mismatch** — a mint site disagrees with the
  declared kind or label set of the metric it mints.
* **RD006 span-name-literal** — a ``.span(...)`` / ``.event(...)`` /
  ``.complete(...)`` call in ``bigdl_tpu_torch/serving/`` (or in any module
  importing ``bigdl_tpu_torch.serving.spans``) names its span with a string
  literal instead of a ``serving/spans.py`` constant; a typo'd literal
  silently forks the request-trace timeline the same way a typo'd
  metric name forks a dashboard.
* **RD007 missing-or-illegal-fleet-policy** — every family in
  ``obs/names.py`` must carry a legal fleet aggregation policy for the
  hierarchical rollup tier (``obs/rollup.py``): counters and
  histograms are additive (``sum`` only — declaring anything else is
  flagged), while a gauge must *explicitly* pick ``max``/``min``/
  ``last``.  A ``sum`` gauge is almost always a unit error (summing
  ratios, summing per-host clocks); the rare legitimate one — a count
  published as a gauge — opts in with an inline
  ``# graftlint: disable=RD007``.

* **RD008 implicit-selfobs-policy** — the observability plane's own
  families (``bigdl_prof_*`` continuous-profiler self-metrics,
  ``bigdl_bundle_*`` debug-bundle accounting) exist to be fleet-rolled
  — a misconfigured high-rate profiler is only visible if its overhead
  gauge rides the rollup tier — so every one must spell its fleet
  policy *explicitly*: counters/histograms write ``policy='sum'``
  (where ordinary families may rely on the additive default), gauges
  declare theirs as usual (RD007 already forces that).  A new
  ``bigdl_prof_*``/``bigdl_bundle_*`` family therefore cannot land
  without a conscious rollup decision in ``obs/names.py``.

Env var *writes* are exempt everywhere: exporting ``BIGDL_*`` into a
child's environment is the supervisor/harness contract.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from bigdl_tpu_torch.analysis import core
from bigdl_tpu_torch.analysis.core import (Finding, ModuleInfo,
                                           dotted_name, str_const)

RULES = {
    "RD001": "BIGDL_* env var read but not declared in config.py",
    "RD002": "raw BIGDL_* env read in library code (use config)",
    "RD003": "bigdl_* metric name not declared in obs/names.py",
    "RD004": "declared metric neither rendered by report.py nor documented",
    "RD005": "mint site disagrees with the declared metric kind/labels",
    "RD006": "serving span/event named by a string literal "
             "(use bigdl_tpu_torch/serving/spans.py constants)",
    "RD007": "metric family missing a legal fleet aggregation policy "
             "(gauges must declare max/min/last; sum gauges opt in)",
    "RD008": "bigdl_prof_*/bigdl_bundle_* self-metric family relies on "
             "an implicit fleet policy (spell policy='sum' out)",
}
core.ALL_RULES.update(RULES)

#: the fleet-policy vocabulary (mirrors obs/names.py POLICIES) and the
#: subset a gauge may declare without an explicit RD007 opt-in
_POLICIES = ("sum", "max", "min", "last")
_GAUGE_POLICIES = ("max", "min", "last")
#: the self-observability families RD008 holds to an *explicit*-policy
#: standard (the profiling + debug-bundle planes)
_SELFOBS_PREFIXES = ("bigdl_prof_", "bigdl_bundle_")

# metric-name shape: no trailing/double underscore (tempdir prefixes
# like "bigdl_serve_smoke_" are spellings, not families)
_METRIC_RE = re.compile(r"bigdl_[a-z0-9]+(?:_[a-z0-9]+)*")
_ENV_HELPERS = {"_env_bool", "_env_int", "_env_opt_int", "_env_float",
                "_env_str"}
_MINT_METHODS = {"counter", "gauge", "histogram"}
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")
_SPAN_METHODS = {"span", "event", "complete"}
_SPANS_MODULE = "bigdl_tpu_torch.serving.spans"


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _DeclaredMetric:
    def __init__(self, name, kind, labels, const, line, doc,
                 policy=None):
        self.name = name
        self.kind = kind
        self.labels = labels
        self.const = const
        self.line = line
        self.doc = doc
        self.policy = policy


def parse_config_declarations(path: str) -> Tuple[Set[str], Set[str]]:
    """(declared env vars, harness bootstrap vars) from config.py."""
    declared: Set[str] = set()
    harness: Set[str] = set()
    if not os.path.exists(path):
        return declared, harness
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in _ENV_HELPERS and node.args:
            v = str_const(node.args[0])
            if v:
                declared.add(v)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "HARNESS_ENV":
            for e in ast.walk(node.value):
                v = str_const(e)
                if v:
                    harness.add(v)
    return declared, harness


def parse_names_registry(path: str) -> Tuple[Dict[str, _DeclaredMetric],
                                             Set[str]]:
    """Declared metric specs + KNOWN_STRINGS from obs/names.py (AST —
    the linter must work on a tree that doesn't import)."""
    declared: Dict[str, _DeclaredMetric] = {}
    known: Set[str] = set()
    if not os.path.exists(path):
        return declared, known
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        const = node.targets[0].id
        if const == "KNOWN_STRINGS":
            for e in ast.walk(node.value):
                v = str_const(e)
                if v:
                    known.add(v)
            continue
        call = node.value
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Name)
                and call.func.id == "_m" and call.args):
            continue
        name = str_const(call.args[0])
        if not name:
            continue
        kind = str_const(call.args[1]) if len(call.args) > 1 else None
        labels: Tuple[str, ...] = ()
        doc = ""
        policy = None
        if len(call.args) > 2 and isinstance(call.args[2],
                                             (ast.Tuple, ast.List)):
            labels = tuple(str_const(e) or "" for e in call.args[2].elts)
        if len(call.args) > 4:
            doc = str_const(call.args[4]) or ""
        if len(call.args) > 5:
            policy = str_const(call.args[5])
        for kw in call.keywords:
            if kw.arg == "labels" and isinstance(kw.value,
                                                 (ast.Tuple, ast.List)):
                labels = tuple(str_const(e) or "" for e in kw.value.elts)
            elif kw.arg == "doc":
                doc = str_const(kw.value) or ""
            elif kw.arg == "kind":
                kind = str_const(kw.value)
            elif kw.arg == "policy":
                policy = str_const(kw.value)
        declared[name] = _DeclaredMetric(name, kind, labels, const,
                                         node.lineno, doc, policy)
    return declared, known


class RegistryRules:
    """The RD pack.  Registry locations default to the real tree and
    are injectable so rule unit tests can point at fixtures."""

    rules = RULES

    def __init__(self, config_path: Optional[str] = None,
                 names_path: Optional[str] = None,
                 report_path: Optional[str] = None):
        root = _pkg_root()
        self.config_path = config_path or os.path.join(root, "config.py")
        self.names_path = names_path or os.path.join(root, "obs",
                                                     "names.py")
        self.report_path = report_path or os.path.join(root, "obs",
                                                       "report.py")
        self.declared_env, self.harness_env = parse_config_declarations(
            self.config_path)
        self.metrics, self.known_strings = parse_names_registry(
            self.names_path)
        self._names_lines: Optional[List[str]] = None

    # --------------------------------------------------------- helpers
    def _metric_declared(self, name: str) -> bool:
        if name in self.metrics or name in self.known_strings:
            return True
        for suffix in _HIST_SUFFIXES:
            if name.endswith(suffix):
                spec = self.metrics.get(name[: -len(suffix)])
                if spec is not None and spec.kind == "histogram":
                    return True
        return False

    def _names_module_aliases(self, tree) -> Tuple[Set[str], Set[str]]:
        """(module aliases of obs.names, constants imported from it)."""
        mod_aliases: Set[str] = set()
        const_imports: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "bigdl_tpu_torch.obs.names":
                        mod_aliases.add(a.asname or "names")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "bigdl_tpu_torch.obs.names":
                    for a in node.names:
                        const_imports.add(a.asname or a.name)
                elif node.module == "bigdl_tpu_torch.obs":
                    for a in node.names:
                        if a.name == "names":
                            mod_aliases.add(a.asname or "names")
        return mod_aliases, const_imports

    # ----------------------------------------------------------- visit
    def visit_module(self, mod: ModuleInfo) -> List[Finding]:
        findings: List[Finding] = []
        is_names_file = os.path.abspath(mod.path) == os.path.abspath(
            self.names_path)
        findings.extend(self._check_env_reads(mod))
        if not is_names_file:
            findings.extend(self._check_metric_names(mod))
        findings.extend(self._check_span_literals(mod))
        return findings

    # ---------------------------------------------------- span literals
    def _imports_spans(self, tree) -> bool:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                if any(a.name == _SPANS_MODULE for a in node.names):
                    return True
            elif isinstance(node, ast.ImportFrom):
                if node.module == _SPANS_MODULE:
                    return True
                if node.module == "bigdl_tpu_torch.serving" and any(
                        a.name == "spans" for a in node.names):
                    return True
        return False

    def _check_span_literals(self, mod: ModuleInfo) -> List[Finding]:
        """RD006: span-name registry drift — the serving tier (and any
        module that opted into ``serving/spans.py`` by importing it)
        must name its tracer spans/events from the constants."""
        rel = mod.relpath.replace(os.sep, "/")
        in_serving = "bigdl_tpu_torch/serving/" in rel or rel.startswith(
            "serving/")
        if not in_serving and not self._imports_spans(mod.tree):
            return []
        findings = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SPAN_METHODS and node.args):
                continue
            name = str_const(node.args[0])
            if name is None:
                continue
            findings.append(mod.finding(
                "RD006", node,
                f"span/event {name!r} named by a string literal — name "
                "it in bigdl_tpu_torch/serving/spans.py and reference the "
                "constant (a typo'd literal forks the request-trace "
                "timeline silently)"))
        return findings

    # -------------------------------------------------------- env reads
    def _check_env_reads(self, mod: ModuleInfo) -> List[Finding]:
        findings = []
        for node, parents in core.walk_with_parents(mod.tree):
            key = None
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and dotted_name(node.value) in ("os.environ",
                                                    "environ"):
                key = str_const(node.slice)
            elif isinstance(node, ast.Call):
                fname = dotted_name(node.func)
                if fname in ("os.getenv",) and node.args:
                    key = str_const(node.args[0])
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "get" \
                        and dotted_name(node.func.value) in (
                            "os.environ", "environ") and node.args:
                    key = str_const(node.args[0])
            if not key or not key.startswith("BIGDL_"):
                continue
            if key in self.harness_env:
                if mod.is_library:
                    findings.append(mod.finding(
                        "RD001", node,
                        f"harness bootstrap var {key} read from library "
                        "code; it is a scripts-only contract"))
                continue
            if key not in self.declared_env:
                findings.append(mod.finding(
                    "RD001", node,
                    f"{key} read from the environment but not declared "
                    "in bigdl_tpu_torch/config.py — declare a config field "
                    "(or add it to HARNESS_ENV) so `config.describe()` "
                    "stays the single source of truth"))
            elif mod.is_library:
                findings.append(mod.finding(
                    "RD002", node,
                    f"raw os.environ read of {key} in framework code; "
                    "read it through bigdl_tpu_torch.config (configure() "
                    "overrides and refresh_from_env() are bypassed "
                    "here)"))
        return findings

    # ---------------------------------------------------- metric names
    def _resolve_metric_arg(self, expr, consts: Dict[str, ast.AST],
                            mod_aliases: Set[str],
                            const_imports: Set[str]
                            ) -> Tuple[Optional[str], str]:
        """(metric name, 'literal'|'const'|'unknown') for a mint call's
        first argument."""
        s = str_const(expr)
        if s is not None:
            return s, "literal"
        if isinstance(expr, ast.Starred):
            expr = expr.value
            if isinstance(expr, ast.Name) and expr.id in consts:
                v = consts[expr.id]
                if isinstance(v, (ast.Tuple, ast.List)) and v.elts:
                    return self._resolve_metric_arg(
                        v.elts[0], consts, mod_aliases, const_imports)
            return None, "unknown"
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id in mod_aliases:
            for spec in self.metrics.values():
                if spec.const == expr.attr:
                    return spec.name, "const"
            return None, "badconst"
        if isinstance(expr, ast.Name):
            if expr.id in const_imports:
                for spec in self.metrics.values():
                    if spec.const == expr.id:
                        return spec.name, "const"
                return None, "badconst"
            if expr.id in consts:
                return self._resolve_metric_arg(
                    consts[expr.id], consts, mod_aliases, const_imports)
        return None, "unknown"

    def _check_metric_names(self, mod: ModuleInfo) -> List[Finding]:
        findings = []
        mod_aliases, const_imports = self._names_module_aliases(mod.tree)
        consts: Dict[str, ast.AST] = {}
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                consts[node.targets[0].id] = node.value

        mint_literal_lines: Set[Tuple[int, str]] = set()
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MINT_METHODS and node.args):
                continue
            name, form = self._resolve_metric_arg(
                node.args[0], consts, mod_aliases, const_imports)
            if form == "badconst":
                findings.append(mod.finding(
                    "RD003", node,
                    "metric constant does not exist in "
                    "bigdl_tpu_torch/obs/names.py"))
                continue
            if name is None or not name.startswith("bigdl_"):
                continue
            spec = self.metrics.get(name)
            if spec is None:
                findings.append(mod.finding(
                    "RD003", node,
                    f"metric {name!r} minted but not declared in "
                    "bigdl_tpu_torch/obs/names.py — declare it there (kind, "
                    "labels, cardinality ceiling, doc)"))
                mint_literal_lines.add((node.lineno, name))
                continue
            if form == "literal" and mod.is_library:
                findings.append(mod.finding(
                    "RD003", node,
                    f"metric {name!r} minted from a string literal in "
                    "framework code; mint from the "
                    f"bigdl_tpu_torch.obs.names.{spec.const} constant"))
            # RD005: declared shape must match the mint site
            if node.func.attr != spec.kind:
                findings.append(mod.finding(
                    "RD005", node,
                    f"{name} is declared a {spec.kind} but minted with "
                    f".{node.func.attr}()"))
            for kw in node.keywords:
                if kw.arg != "labels":
                    continue
                if isinstance(kw.value, (ast.Tuple, ast.List)):
                    got = tuple(str_const(e) or "?"
                                for e in kw.value.elts)
                    if set(got) != set(spec.labels):
                        findings.append(mod.finding(
                            "RD005", node,
                            f"{name} is declared with labels "
                            f"{spec.labels!r} but minted with "
                            f"{got!r}"))

        # every exact bigdl_* spelling must be a declared family, a
        # histogram derivation of one, or a KNOWN_STRINGS entry
        for node in ast.walk(mod.tree):
            s = str_const(node)
            if s is None or not _METRIC_RE.fullmatch(s):
                continue
            if self._metric_declared(s):
                continue
            if (node.lineno, s) in mint_literal_lines:
                continue  # already reported as an undeclared mint
            findings.append(mod.finding(
                "RD003", node,
                f"bigdl_* spelling {s!r} is not a declared metric "
                "family (bigdl_tpu_torch/obs/names.py) — declare it, or add "
                "it to names.KNOWN_STRINGS if it is not a metric"))
        return findings

    # -------------------------------------------------------- finalize
    def _names_rel(self) -> str:
        """The registry's path as findings (and inline suppressions)
        see it: cut at the ``bigdl_tpu_torch`` package component, else
        repo-root-relative (fixture registries under ``tests/``)."""
        names_rel = self.names_path.replace(os.sep, "/")
        parts = names_rel.split("/")
        for i, part in enumerate(parts):
            if part == "bigdl_tpu_torch":
                return "/".join(parts[i:])
        return os.path.relpath(
            self.names_path,
            os.path.dirname(_pkg_root())).replace(os.sep, "/")

    def finalize(self) -> List[Finding]:
        findings = []
        report_text = ""
        if os.path.exists(self.report_path):
            with open(self.report_path, encoding="utf-8") as fh:
                report_text = fh.read()
        names_rel = self._names_rel()
        for spec in sorted(self.metrics.values(), key=lambda s: s.line):
            rendered = (spec.name in report_text
                        or spec.const in report_text)
            if not rendered and not spec.doc.strip():
                findings.append(Finding(
                    "RD004", names_rel, spec.line,
                    f"{spec.name} is declared but neither rendered by "
                    "obs/report.py nor documented (doc=...) — an "
                    "operator can't discover what it means"))
            findings.extend(self._check_policy(spec, names_rel))
        return findings

    def _rd007_suppressed(self, line: int, rule: str = "RD007") -> bool:
        """Inline ``# graftlint: disable=<rule>`` on the declaration (or
        the line above) — honored here because the registry file is
        usually *not* among the linted modules, so the core suppression
        pass never sees its comments."""
        if self._names_lines is None:
            try:
                with open(self.names_path, encoding="utf-8") as fh:
                    self._names_lines = fh.read().splitlines()
            except OSError:
                self._names_lines = []
        for ln in (line, line - 1):
            if not 1 <= ln <= len(self._names_lines):
                continue
            m = core._DIRECTIVE_RE.search(self._names_lines[ln - 1])
            if m and m.group(1) == "disable":
                rules = core._directive_rules(m)
                if rules is None or rule in rules:
                    return True
        return False

    def _check_policy(self, spec, names_rel: str) -> List[Finding]:
        """RD007: the fleet aggregation policy contract every family
        must satisfy before the rollup tier may merge it."""
        if spec.kind not in ("counter", "gauge", "histogram"):
            return []  # kind errors are names.py's own ValueError
        if self._rd007_suppressed(spec.line):
            return []
        p = spec.policy
        if spec.kind in ("counter", "histogram"):
            if p is not None and p != "sum":
                return [Finding(
                    "RD007", names_rel, spec.line,
                    f"{spec.name}: a {spec.kind} merges additively "
                    f"across the fleet — policy {p!r} is illegal "
                    "(omit it or declare 'sum')")]
            # RD008: the self-observability planes may not lean on the
            # additive default — a new bigdl_prof_*/bigdl_bundle_*
            # family lands with its rollup decision written down
            if p is None and spec.name.startswith(_SELFOBS_PREFIXES) \
                    and not self._rd007_suppressed(spec.line, "RD008"):
                return [Finding(
                    "RD008", names_rel, spec.line,
                    f"{spec.name}: {spec.kind} in the "
                    "profiling/debug-bundle plane relies on the "
                    "implicit additive policy — these families feed "
                    "the fleet rollup that makes a misconfigured "
                    "profiler visible, so spell policy='sum' "
                    "explicitly")]
            return []
        # gauges: an explicit, legal policy is the whole point
        if p is None:
            return [Finding(
                "RD007", names_rel, spec.line,
                f"{spec.name}: gauge declares no fleet aggregation "
                "policy — the rollup tier cannot guess whether the "
                "fleet value is the max, min or newest host; declare "
                "policy='max'|'min'|'last'")]
        if p not in _POLICIES:
            return [Finding(
                "RD007", names_rel, spec.line,
                f"{spec.name}: unknown fleet policy {p!r} "
                f"(legal: {', '.join(_POLICIES)})")]
        if p not in _GAUGE_POLICIES:
            return [Finding(
                "RD007", names_rel, spec.line,
                f"{spec.name}: policy='sum' on a gauge is almost "
                "always a unit error (summing ratios or clocks); if "
                "this gauge really is an additive count, opt in with "
                "an inline '# graftlint: disable=RD007'")]
        return []
