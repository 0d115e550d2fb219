"""graftlint core: findings, suppression, baseline, and the linter.

The linter is one AST pass per file plus cross-file finalizers (the
JAX package's ``bigdl_tpu/analysis/core.py``).  Rule packs
(``concurrency``, ``registry_rules``) implement::

    class Pack:
        rules: dict[rule_id -> one-line description]
        def visit_module(self, mod: ModuleInfo) -> list[Finding]
        def finalize(self) -> list[Finding]     # cross-file rules

Findings carry ``rule`` + ``path:line`` + message.  Two suppression
layers sit between a raw finding and a nonzero exit:

* **inline comments** — ``# graftlint: disable=RD003`` on the finding's
  line (or the line above) silences the named rule(s) there;
  ``# graftlint: disable-file=CC002`` anywhere in a file silences the
  rule file-wide;
* **the baseline file** — accepted legacy findings, kept as
  ``bigdl_tpu_torch/analysis/baseline.json`` (the port's pass needs
  none: it has no such file).  Matching is content-addressed
  (rule + path + hash of the stripped source line + occurrence index),
  so findings survive unrelated line drift but expire when the
  offending line changes or disappears.  New findings always fail.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

#: rule id -> one-line description, merged from the packs at import
ALL_RULES: Dict[str, str] = {
    "GL000": "file does not parse (syntax error)",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # posix relpath from the lint root
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass
class ModuleInfo:
    """One parsed file handed to every rule pack."""

    path: str          # absolute
    relpath: str       # posix, relative to the lint root
    text: str
    lines: List[str]
    tree: ast.AST
    is_library: bool   # framework code (bigdl_tpu_torch/**, not config.py)

    def finding(self, rule: str, node, message: str) -> Finding:
        line = getattr(node, "lineno", 0) if not isinstance(node, int) \
            else node
        return Finding(rule, self.relpath, line, message)


# ------------------------------------------------------------------ AST util
def dotted_name(node) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_with_parents(tree):
    """Yield ``(node, parents)`` with ``parents`` innermost-last."""
    stack = [(tree, ())]
    while stack:
        node, parents = stack.pop()
        yield node, parents
        for child in ast.iter_child_nodes(node):
            stack.append((child, parents + (node,)))


# ------------------------------------------------------------ file discovery
def collect_files(paths: Sequence[str], root: str) -> List[str]:
    """Every ``*.py`` under ``paths`` (files or directories), sorted,
    __pycache__ and dot-directories excluded."""
    out = []
    for p in paths:
        ap = os.path.join(root, p) if not os.path.isabs(p) else p
        if os.path.isfile(ap):
            if ap.endswith(".py"):
                out.append(ap)
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__" and not d.startswith("."))
            for f in sorted(filenames):
                if f.endswith(".py"):
                    out.append(os.path.join(dirpath, f))
    return sorted(dict.fromkeys(out))


def load_module(path: str, root: str,
                lib_mode: str = "auto") -> Tuple[Optional[ModuleInfo],
                                                 Optional[Finding]]:
    relpath = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    if lib_mode == "auto":
        is_library = (relpath.startswith("bigdl_tpu_torch/")
                      and relpath != "bigdl_tpu_torch/config.py")
    else:
        is_library = bool(lib_mode)
    try:
        tree = ast.parse(text, filename=relpath)
    except SyntaxError as e:
        return None, Finding("GL000", relpath, e.lineno or 0,
                             f"syntax error: {e.msg}")
    return ModuleInfo(path, relpath, text, text.splitlines(), tree,
                      is_library), None


# -------------------------------------------------------------- suppression
_DIRECTIVE_RE = re.compile(
    r"#\s*graftlint:\s*(disable-file|disable)(?:=([A-Za-z0-9_,\s]+))?")


def _directive_rules(match) -> Optional[frozenset]:
    """None means "all rules"."""
    if match.group(2) is None:
        return None
    return frozenset(r.strip() for r in match.group(2).split(",")
                     if r.strip())


def apply_suppressions(findings: List[Finding],
                       modules: Dict[str, ModuleInfo]) -> List[Finding]:
    """Drop findings silenced by inline ``# graftlint:`` comments."""
    per_file: Dict[str, Tuple[dict, Optional[frozenset], dict]] = {}
    for relpath, mod in modules.items():
        line_rules: Dict[int, Optional[frozenset]] = {}
        file_rules: set = set()
        file_all = False
        for i, line in enumerate(mod.lines, start=1):
            m = _DIRECTIVE_RE.search(line)
            if not m:
                continue
            rules = _directive_rules(m)
            if m.group(1) == "disable-file":
                if rules is None:
                    file_all = True
                else:
                    file_rules |= rules
            else:
                line_rules[i] = rules
        per_file[relpath] = (line_rules, file_rules, file_all)
    out = []
    for f in findings:
        line_rules, file_rules, file_all = per_file.get(
            f.path, ({}, set(), False))
        if file_all or f.rule in file_rules:
            continue
        suppressed = False
        for ln in (f.line, f.line - 1):
            rules = line_rules.get(ln, "absent")
            if rules == "absent":
                continue
            if rules is None or f.rule in rules:
                suppressed = True
                break
        if not suppressed:
            out.append(f)
    return out


# ----------------------------------------------------------------- baseline
BASELINE_VERSION = 1
DEFAULT_BASELINE = "bigdl_tpu_torch/analysis/baseline.json"


def _context_hash(mod: Optional[ModuleInfo], line: int) -> str:
    """12 hex chars of the stripped source line — the content address a
    baseline entry matches on, so findings survive line drift."""
    text = ""
    if mod is not None and 1 <= line <= len(mod.lines):
        text = mod.lines[line - 1].strip()
    return hashlib.sha1(text.encode("utf-8")).hexdigest()[:12]


def _keyed(findings: List[Finding],
           modules: Dict[str, ModuleInfo]) -> List[Tuple[tuple, Finding]]:
    """Pair each finding with its (rule, path, context, index) key;
    ``index`` disambiguates identical lines in one file."""
    seen: Dict[tuple, int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        base = (f.rule, f.path, _context_hash(modules.get(f.path), f.line))
        idx = seen.get(base, 0)
        seen[base] = idx + 1
        out.append((base + (idx,), f))
    return out


def write_baseline(path: str, findings: List[Finding],
                   modules: Dict[str, ModuleInfo]):
    entries = [{"rule": k[0], "path": k[1], "context": k[2], "index": k[3],
                "message": f.message}
               for k, f in _keyed(findings, modules)]
    doc = {"version": BASELINE_VERSION, "findings": entries}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def load_baseline(path: str) -> Optional[List[dict]]:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: unsupported baseline schema")
    return list(doc.get("findings", ()))


def apply_baseline(findings: List[Finding],
                   modules: Dict[str, ModuleInfo],
                   entries: List[dict]
                   ) -> Tuple[List[Finding], List[dict]]:
    """Split into (fresh findings, stale baseline entries).  A baseline
    entry absorbs at most one matching finding; entries that match
    nothing are stale (the violation was fixed — expire them with
    ``--write-baseline``)."""
    budget: Dict[tuple, int] = {}
    for e in entries:
        key = (e["rule"], e["path"], e["context"], int(e.get("index", 0)))
        budget[key] = budget.get(key, 0) + 1
    fresh = []
    for key, f in _keyed(findings, modules):
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            fresh.append(f)
    stale = []
    for e in entries:
        key = (e["rule"], e["path"], e["context"], int(e.get("index", 0)))
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            stale.append(e)
    return fresh, stale


# ------------------------------------------------------------------- linter
class Linter:
    """Parse every file once, run the packs, return raw findings
    (suppression comments already honored; baseline is the CLI's job so
    the API stays side-effect free)."""

    def __init__(self, paths: Sequence[str], root: Optional[str] = None,
                 rules: Optional[Sequence[str]] = None,
                 lib_mode: str = "auto", packs=None):
        self.root = os.path.abspath(root or os.getcwd())
        self.paths = list(paths)
        self.rules = set(rules) if rules else None
        self.lib_mode = lib_mode
        if packs is None:
            from bigdl_tpu_torch.analysis.concurrency import ConcurrencyRules
            from bigdl_tpu_torch.analysis.registry_rules import RegistryRules

            packs = [ConcurrencyRules(), RegistryRules()]
        self.packs = packs
        self.modules: Dict[str, ModuleInfo] = {}

    def run(self) -> List[Finding]:
        findings: List[Finding] = []
        for path in collect_files(self.paths, self.root):
            mod, err = load_module(path, self.root, self.lib_mode)
            if err is not None:
                findings.append(err)
                continue
            self.modules[mod.relpath] = mod
            for pack in self.packs:
                findings.extend(pack.visit_module(mod))
        for pack in self.packs:
            findings.extend(pack.finalize())
        if self.rules is not None:
            findings = [f for f in findings if f.rule in self.rules]
        findings = apply_suppressions(findings, self.modules)
        findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
        return findings
