"""graftlint CC rules: thread/lock discipline (the JAX package's
``bigdl_tpu/analysis/concurrency.py``, unchanged in substance).

The stack runs real threads in production — the obs HTTP server, the
stream producer, the serving engine loop, the background checkpoint
writer, the supervisor watchdog — and the deadlocks/races they can
produce never show up in a single-threaded pytest run.  These rules
are intraprocedural with one level of honesty: lock acquisitions are
``with``-statements over *known* locks (attributes assigned
``threading.Lock/RLock/Condition`` in the class, or module-level
ones), and call effects propagate through same-class / same-module
calls to a fixpoint.

* **CC001 lock-order-cycle** — a global graph over "held A while
  acquiring B" edges (direct ``with`` nesting plus calls made while
  holding a lock, using each callee's may-acquire summary).  Any cycle
  — including re-acquiring a non-reentrant ``Lock`` you already hold —
  is a latent deadlock: two threads entering the cycle from different
  edges stall forever.
* **CC002 unlocked-shared-write** — an attribute written on ``self``
  from a thread entry point (a method handed to
  ``threading.Thread(target=...)`` or a ``Thread`` subclass ``run``,
  plus everything those reach through self-calls) without holding one
  of the class's locks, when the same attribute is also written from
  non-thread methods.  That's a write-write race on CPython and a
  torn invariant everywhere else.
* **CC003 bare-acquire** — ``lock.acquire()`` without a matching
  ``finally: lock.release()``: any exception between the two leaks the
  lock and wedges every later waiter.  Use ``with``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from bigdl_tpu_torch.analysis import core
from bigdl_tpu_torch.analysis.core import Finding, ModuleInfo, dotted_name

RULES = {
    "CC001": "inconsistent lock acquisition order (deadlock cycle)",
    "CC002": "shared attribute written from a thread without its lock",
    "CC003": "lock.acquire() without try/finally release",
}
core.ALL_RULES.update(RULES)

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "cond"}


def _lock_ctor_kind(call) -> Optional[str]:
    if not isinstance(call, ast.Call):
        return None
    name = dotted_name(call.func)
    if name is None:
        return None
    last = name.rpartition(".")[2]
    return _LOCK_CTORS.get(last)


@dataclasses.dataclass
class _FuncSummary:
    key: str                                   # "relpath::Class.m"
    acquires: List[Tuple[str, int, tuple]]     # (lock, line, held-at)
    calls: List[Tuple[str, int, tuple]]        # (callee key, line, held)
    writes: List[Tuple[str, int, bool]]        # (attr, line, under lock)


class _ClassInfo:
    def __init__(self, relpath: str, name: str):
        self.relpath = relpath
        self.name = name
        self.lock_attrs: Dict[str, str] = {}   # attr -> kind
        self.methods: Dict[str, ast.AST] = {}
        self.entries: Set[str] = set()

    def lock_id(self, attr: str) -> str:
        return f"{self.relpath}::{self.name}.{attr}"


class ConcurrencyRules:
    """The CC pack.  CC002/CC003 report per module; CC001 accumulates a
    global lock graph and reports in :meth:`finalize`."""

    rules = RULES

    def __init__(self):
        # (from_lock, to_lock) -> (path, line) of the inner acquisition
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.lock_kinds: Dict[str, str] = {}

    # ------------------------------------------------------------ visit
    def visit_module(self, mod: ModuleInfo) -> List[Finding]:
        findings: List[Finding] = []
        module_locks: Dict[str, str] = {}
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                kind = _lock_ctor_kind(node.value)
                if kind:
                    module_locks[node.targets[0].id] = kind
                    self.lock_kinds[f"{mod.relpath}::"
                                    f"{node.targets[0].id}"] = kind

        classes: List[_ClassInfo] = []
        module_funcs: Dict[str, ast.AST] = {}
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                module_funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                classes.append(self._scan_class(mod, node))

        # build per-function summaries
        summaries: Dict[str, _FuncSummary] = {}
        for cls in classes:
            for mname, fn in cls.methods.items():
                key = f"{mod.relpath}::{cls.name}.{mname}"
                summaries[key] = self._summarize(
                    mod, fn, key, cls, module_locks, module_funcs,
                    findings)
        for fname, fn in module_funcs.items():
            key = f"{mod.relpath}::{fname}"
            summaries[key] = self._summarize(
                mod, fn, key, None, module_locks, module_funcs, findings)

        # may-acquire fixpoint through same-module calls
        may: Dict[str, Set[str]] = {
            k: {l for l, _, _ in s.acquires} for k, s in summaries.items()}
        changed = True
        while changed:
            changed = False
            for k, s in summaries.items():
                for callee, _, _ in s.calls:
                    extra = may.get(callee, set()) - may[k]
                    if extra:
                        may[k] |= extra
                        changed = True

        # lock-order edges (held -> acquired), direct and through calls
        for k, s in summaries.items():
            for lock, line, held in s.acquires:
                for h in held:
                    self.edges.setdefault((h, lock), (mod.relpath, line))
            for callee, line, held in s.calls:
                for lock in may.get(callee, ()):
                    for h in held:
                        self.edges.setdefault((h, lock),
                                              (mod.relpath, line))

        # CC002: unlocked writes from thread-entry closures
        for cls in classes:
            findings.extend(self._check_shared_writes(
                mod, cls, summaries))
        return findings

    # ------------------------------------------------------- class scan
    def _scan_class(self, mod: ModuleInfo, node: ast.ClassDef) -> _ClassInfo:
        cls = _ClassInfo(mod.relpath, node.name)
        thread_base = any(
            (dotted_name(b) or "").rpartition(".")[2] == "Thread"
            for b in node.bases)
        for item in node.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            cls.methods[item.name] = item
            for sub in ast.walk(item):
                if isinstance(sub, ast.Assign):
                    kind = _lock_ctor_kind(sub.value)
                    if kind:
                        for t in sub.targets:
                            if isinstance(t, ast.Attribute) \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self":
                                cls.lock_attrs[t.attr] = kind
                                self.lock_kinds[cls.lock_id(t.attr)] = kind
                if isinstance(sub, ast.Call):
                    fname = dotted_name(sub.func) or ""
                    if fname.rpartition(".")[2] == "Thread":
                        for kw in sub.keywords:
                            if kw.arg == "target" \
                                    and isinstance(kw.value, ast.Attribute) \
                                    and isinstance(kw.value.value, ast.Name) \
                                    and kw.value.value.id == "self":
                                cls.entries.add(kw.value.attr)
        if thread_base and "run" in cls.methods:
            cls.entries.add("run")
        return cls

    # -------------------------------------------------------- summaries
    def _resolve_lock(self, expr, cls: Optional[_ClassInfo],
                      module_locks: Dict[str, str],
                      relpath: str) -> Optional[str]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls is not None \
                and expr.attr in cls.lock_attrs:
            return cls.lock_id(expr.attr)
        if isinstance(expr, ast.Name) and expr.id in module_locks:
            return f"{relpath}::{expr.id}"
        return None

    def _summarize(self, mod: ModuleInfo, fn, key: str,
                   cls: Optional[_ClassInfo],
                   module_locks: Dict[str, str],
                   module_funcs: Dict[str, ast.AST],
                   findings: List[Finding]) -> _FuncSummary:
        s = _FuncSummary(key, [], [], [])
        relpath = mod.relpath
        acquire_sites: List[Tuple[str, ast.AST]] = []
        finally_releases: List[Tuple[str, ast.AST]] = []
        parents: Dict[ast.AST, ast.AST] = {}

        def visit(node, held: tuple):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
            if isinstance(node, ast.With):
                inner = held
                for item in node.items:
                    lock = self._resolve_lock(
                        item.context_expr, cls, module_locks, relpath)
                    if lock:
                        s.acquires.append((lock, node.lineno, inner))
                        inner = inner + (lock,)
                for b in node.body:
                    visit(b, inner)
                return
            if isinstance(node, ast.Call):
                # same-class / same-module call targets
                if isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self" \
                        and cls is not None \
                        and node.func.attr in cls.methods:
                    s.calls.append((f"{relpath}::{cls.name}."
                                    f"{node.func.attr}",
                                    node.lineno, held))
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in module_funcs:
                    s.calls.append((f"{relpath}::{node.func.id}",
                                    node.lineno, held))
                # CC003 bookkeeping
                if isinstance(node.func, ast.Attribute):
                    lock = self._resolve_lock(
                        node.func.value, cls, module_locks, relpath)
                    if lock and node.func.attr == "acquire":
                        acquire_sites.append((lock, node))
                    elif lock and node.func.attr == "release":
                        cur = parents.get(node)
                        while cur is not None and not isinstance(
                                cur, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                            if isinstance(cur, ast.Try):
                                finally_releases.append((lock, cur))
                            cur = parents.get(cur)
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self" \
                            and cls is not None \
                            and t.attr not in cls.lock_attrs:
                        s.writes.append((t.attr, node.lineno, bool(held)))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return  # nested callables run on their own schedule
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            parents[stmt] = fn
            visit(stmt, ())

        # CC003: every acquire needs a finally-release of the same lock
        # somewhere in this function (the idiom puts the acquire just
        # BEFORE the try, so an ancestor walk would miss it — a
        # function-wide match is the honest granularity here)
        protected_locks = {l for l, _ in finally_releases}
        for lock, node in acquire_sites:
            if lock not in protected_locks:
                findings.append(mod.finding(
                    "CC003", node,
                    f"{lock.rpartition('::')[2]}.acquire() without a "
                    "try/finally release — an exception here wedges "
                    "every later waiter; use `with`"))
        return s

    # ------------------------------------------------- CC002 evaluation
    def _check_shared_writes(self, mod: ModuleInfo, cls: _ClassInfo,
                             summaries: Dict[str, _FuncSummary]
                             ) -> List[Finding]:
        if not cls.entries or not cls.lock_attrs:
            return []
        # closure of methods reachable from the thread entries
        entry_closure: Set[str] = set()
        stack = [m for m in cls.entries if m in cls.methods]
        prefix = f"{mod.relpath}::{cls.name}."
        while stack:
            m = stack.pop()
            if m in entry_closure:
                continue
            entry_closure.add(m)
            s = summaries.get(prefix + m)
            if s is None:
                continue
            for callee, _, _ in s.calls:
                if callee.startswith(prefix):
                    stack.append(callee[len(prefix):])
        # attributes also written outside the entry closure (+ __init__)
        outside_writers: Dict[str, str] = {}
        for mname in cls.methods:
            if mname in entry_closure or mname == "__init__":
                continue
            s = summaries.get(prefix + mname)
            if s is None:
                continue
            for attr, _, _ in s.writes:
                outside_writers.setdefault(attr, mname)
        findings = []
        for mname in sorted(entry_closure):
            s = summaries.get(prefix + mname)
            if s is None:
                continue
            for attr, line, under_lock in s.writes:
                if under_lock or attr not in outside_writers:
                    continue
                findings.append(Finding(
                    "CC002", mod.relpath, line,
                    f"self.{attr} written from thread entry path "
                    f"{cls.name}.{mname}() without holding a class lock "
                    f"({' / '.join(sorted(cls.lock_attrs))}), but also "
                    f"written by {cls.name}.{outside_writers[attr]}() — "
                    "write-write race"))
        return findings

    # --------------------------------------------------- CC001 finalize
    def finalize(self) -> List[Finding]:
        findings = []
        # self-cycles: re-acquiring a non-reentrant lock you hold
        graph: Dict[str, Set[str]] = {}
        for (a, b), (path, line) in sorted(self.edges.items()):
            if a == b:
                if self.lock_kinds.get(a) == "lock":
                    findings.append(Finding(
                        "CC001", path, line,
                        f"{a.rpartition('::')[2]} is acquired while "
                        "already held and is a non-reentrant "
                        "threading.Lock — guaranteed self-deadlock"))
                continue
            graph.setdefault(a, set()).add(b)

        # cycles among distinct locks: report every edge inside an SCC
        sccs = _tarjan(graph)
        for scc in sccs:
            if len(scc) < 2:
                continue
            members = set(scc)
            pretty = " -> ".join(
                sorted(l.rpartition("::")[2] for l in members))
            for (a, b), (path, line) in sorted(self.edges.items()):
                if a in members and b in members and a != b:
                    findings.append(Finding(
                        "CC001", path, line,
                        f"lock-order cycle [{pretty}]: "
                        f"{b.rpartition('::')[2]} acquired here while "
                        f"holding {a.rpartition('::')[2]}, but another "
                        "path acquires them in the opposite order — "
                        "pick one global order"))
        return findings


def _tarjan(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC (the linter must not recurse its way past
    Python's stack limit on a big lock graph)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]
    nodes = sorted(set(graph) | {v for vs in graph.values() for v in vs})

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if succ not in index:
                    index[succ] = low[succ] = counter[0]
                    counter[0] += 1
                    stack.append(succ)
                    on_stack.add(succ)
                    work.append((succ, iter(sorted(graph.get(succ, ())))))
                    advanced = True
                    break
                if succ in on_stack:
                    low[node] = min(low[node], index[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)
    return sccs
