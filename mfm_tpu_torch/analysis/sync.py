"""mfmsync — lock-discipline & shared-state static analysis for the port's
serving fleet (counterpart of ``mfm_tpu/analysis/sync.py``).

The port carries the reference's concurrency over unchanged: the
coalescer's flusher thread, the front end's per-connection threads, the
replicas' pipe pumps, the breaker, the response cache, the fleet and the
obs registry share mutable state under ``threading.Lock/RLock/Condition``.
This pass is the reference's, over ``mfm_tpu_torch``: stdlib-only AST
analysis on :mod:`mfm_tpu_torch.lint`'s module index and call graph, a
``(file, rule, qualname)`` keyed baseline with stale detection, and a
``--strict`` gate.

Rules:

  S1  unguarded access to a guarded field.  Per class, a field counts as
      *guarded* when at least one write to it outside ``__init__``
      happens while the class's lock is held; every other read or write
      of it outside ``__init__`` must then also hold the lock.
  S2  lock-order hazard: a cycle in the lock-acquisition order graph
      (potential deadlock), or re-acquiring a non-reentrant
      ``threading.Lock`` already held.  ``threading.Condition(lock)``
      aliases to its underlying lock.
  S3  blocking while holding a lock: socket/pipe I/O (accept/recv/
      sendall/connect/readline), ``subprocess`` spawns, ``time.sleep``,
      argument-less ``.join()``/``.get()``, waiting on a *foreign*
      condition or event, or a call that (transitively) launches device
      work — a call into ``torch``, which enqueues on the card and may
      wait for it.  ``cond.wait()`` on the lock currently held is the one
      legal blocking call (the wait releases it).
  S4  (baseline only) a ``threading.Thread`` target the pass cannot
      resolve to a method of an analyzed class needs a justification.

Held-region inference is the reference's: ``with self._lock:`` and
``with <module lock>:`` blocks; a ``*_locked`` method is entered with its
class's (or module's) lock held; a private method with the intersection
of the held sets at its intra-class call sites (fixed point); thread
targets lock-free; lock identity through inheritance and condition
aliasing.  Its blind spots are the reference's too: fields reached
through another object, callback fields invoked under a lock,
module-global state outside classes, and blocking I/O more than one call
level below a held region.

Like :mod:`mfm_tpu_torch.lint`, this module imports neither torch nor
numpy.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import sys
from typing import Iterable

from mfm_tpu_torch.lint import (
    REPO_ROOT,
    Linter,
    _attr_chain,
    add_gate_flags,
    baseline_path,
    collect_files,
    load_baseline,
    report,
    split_baseline,
)

#: sync analyzes the package only: the smoke and the tools are
#: single-threaded entrypoints, and tests drive the package's primitives
#: directly.  The port keeps its tools inside the package
#: (``mfm_tpu_torch/tools``, the counterpart of the reference's top-level
#: ``tools/``), so they are left out of every run by path: their method
#: names (``Baseline.append``, ...) would otherwise join the bare-name
#: index and reach into the serving classes' calls.
DEFAULT_TARGETS = ("mfm_tpu_torch",)
EXCLUDED = (os.path.join("mfm_tpu_torch", "tools"),)
DEFAULT_BASELINE = os.path.join("mfm_tpu_torch", "tools",
                                "mfmsync_baseline.json")

SYNC_RULES = {
    "S1": "unguarded access to a guarded field — some writes hold the "
          "class lock, this access does not; a concurrent interleaving "
          "can lose updates or observe torn state",
    "S2": "lock-order hazard — a cycle in the lock-acquisition order "
          "graph (potential deadlock) or re-acquiring a non-reentrant "
          "Lock already held",
    "S3": "blocking operation reachable while a lock is held — socket/"
          "pipe I/O, subprocess, time.sleep, bare join()/get(), a "
          "foreign wait(), or device work through torch; every other "
          "thread contending for the lock stalls behind it",
}

#: threading constructors that create a lock-like primitive
_LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition",
               "Semaphore": "Lock", "BoundedSemaphore": "Lock"}

#: queue constructors: queue-typed fields are internally synchronized,
#: so they are exempt from S1 and they mark a class as analyzed for the
#: thread-target coverage check
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}

#: method calls on a self-attribute that mutate it (S1 write detection)
_MUTATORS = {"add", "discard", "remove", "append", "appendleft", "extend",
             "insert", "pop", "popleft", "popitem", "clear", "update",
             "setdefault", "put", "put_nowait", "move_to_end"}

#: attribute calls that block on I/O regardless of receiver type
_BLOCKING_ATTRS = {"accept", "recv", "recv_into", "recvfrom", "sendall",
                   "connect", "readline", "readlines"}

_SUBPROCESS_CALLS = {"run", "Popen", "call", "check_call", "check_output",
                     "communicate"}

#: attribute names so generic (container / threading protocol) that a
#: bare-name match is noise: ``self._done.add(tid)`` must not resolve to
#: some class's unrelated ``add`` method and manufacture lock edges out
#: of thin air.  Confident self/cls MRO resolutions are unaffected, so
#: ``self.put(...)`` inside the owning class still counts.
_GENERIC_ATTRS = _MUTATORS | {
    "wait", "notify", "notify_all", "acquire", "release", "join", "get",
    "close", "items", "keys", "values", "copy", "sort", "index", "count",
    "split", "strip", "encode", "decode", "read", "write",
}


@dataclasses.dataclass
class SyncViolation:
    file: str
    line: int
    rule: str
    qualname: str
    message: str

    def key(self) -> tuple:
        return (self.file, self.rule, self.qualname)

    def render(self) -> str:
        return (f"{self.file}:{self.line}: {self.rule} [{self.qualname}] "
                f"{self.message}\n    doctrine: {SYNC_RULES[self.rule]}")


@dataclasses.dataclass
class ClassInfo:
    qualname: str                 # module:Class
    name: str
    module: str
    file: str
    node: object
    base_names: list = dataclasses.field(default_factory=list)
    #: lock attr -> kind ("Lock" | "RLock" | "Condition" | "unknown")
    lock_attrs: dict = dataclasses.field(default_factory=dict)
    #: condition attr -> underlying lock attr (Condition(self._lock))
    lock_alias: dict = dataclasses.field(default_factory=dict)
    queue_attrs: set = dataclasses.field(default_factory=set)
    #: attrs assigned via plain `self.X = ...` anywhere in the class
    stores: set = dataclasses.field(default_factory=set)
    methods: dict = dataclasses.field(default_factory=dict)  # name -> qual


class _FuncScan(ast.NodeVisitor):
    """One pass over a function body: self-attribute accesses, lock
    acquisitions and call sites, each annotated with the locally-held
    lock set (entry-held context unions in later)."""

    def __init__(self, analyzer, info, cls):
        self.an = analyzer
        self.info = info
        self.cls = cls
        self.local: list = []
        self.accesses: list = []   # (attr, is_write, frozenset, lineno)
        self.acquires: list = []   # (frozenset-before, node, kind, lineno)
        self.calls: list = []      # (ast.Call, frozenset, lineno)

    # nested defs are separate FuncInfos with their own scans
    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _access(self, attr, write, lineno):
        self.accesses.append((attr, write, frozenset(self.local), lineno))

    def _with(self, node):
        acquired = []
        for item in node.items:
            self.visit(item.context_expr)
            lk = self.an._lock_node_of(self.cls, self.info,
                                       item.context_expr)
            if lk is not None:
                self.acquires.append((frozenset(self.local), lk[0], lk[1],
                                      item.context_expr.lineno))
                acquired.append(lk[0])
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        self.local.extend(acquired)
        for s in node.body:
            self.visit(s)
        if acquired:
            del self.local[-len(acquired):]

    visit_With = _with
    visit_AsyncWith = _with

    def visit_Call(self, node):
        self.calls.append((node, frozenset(self.local), node.lineno))
        f = node.func
        # mutator write: self.X.append(...) / .add / .put_nowait / ...
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS and \
                isinstance(f.value, ast.Attribute) and \
                isinstance(f.value.value, ast.Name) and \
                f.value.value.id == "self":
            self._access(f.value.attr, True, node.lineno)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            self._access(node.attr, write, node.lineno)
        self.generic_visit(node)

    def _subscript_write(self, tgt, lineno):
        # self.X[k] = v mutates X even though the AST loads the attribute
        while isinstance(tgt, ast.Subscript):
            tgt = tgt.value
        if isinstance(tgt, ast.Attribute) and \
                isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
            self._access(tgt.attr, True, lineno)

    def visit_Assign(self, node):
        for t in node.targets:
            self._subscript_write(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._subscript_write(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node):
        for t in node.targets:
            self._subscript_write(t, node.lineno)
        self.generic_visit(node)


class SyncAnalyzer:
    """The pass.  Feed it a built :class:`~mfm_tpu_torch.lint.Linter`
    (call graph, imports, torch-touch closure) and call :meth:`run`."""

    def __init__(self, linter: Linter):
        self.lint = linter
        self.classes: dict[str, ClassInfo] = {}      # module:Class -> info
        self.module_locks: dict[str, dict] = {}      # module -> {name: kind}
        self.method_class: dict[str, ClassInfo] = {} # func qual -> class
        self.scans: dict[str, _FuncScan] = {}
        self.entry: dict[str, object] = {}           # qual -> frozenset|None
        self.thread_targets: list = []               # (qual|None, repr, file, line)
        self.lock_kinds: dict[str, str] = {}         # node id -> kind
        self.violations: list[SyncViolation] = []

    # -- discovery ------------------------------------------------------------
    def _ctor_of(self, mod, call) -> tuple | None:
        """('threading'|'queue', ctor-name) for a constructor call."""
        if not isinstance(call, ast.Call):
            return None
        f = call.func
        if isinstance(f, ast.Name):
            src = mod.from_imports.get(f.id)
            if src:
                return (src[0], src[1])
            return None
        chain = _attr_chain(f)
        if not chain or len(chain) < 2:
            return None
        root = mod.module_imports.get(chain[0])
        if root in ("threading", "queue"):
            return (root, chain[-1])
        return None

    def _collect_classes(self):
        for mod in self.lint.modules.values():
            # module-level locks (obs/trace.py style)
            locks = {}
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    ctor = self._ctor_of(mod, stmt.value)
                    if ctor and ctor[0] == "threading" and \
                            ctor[1] in _LOCK_CTORS:
                        locks[stmt.targets[0].id] = _LOCK_CTORS[ctor[1]]
            if locks:
                self.module_locks[mod.name] = locks
            for stmt in mod.tree.body:
                if not isinstance(stmt, ast.ClassDef):
                    continue
                ci = ClassInfo(f"{mod.name}:{stmt.name}", stmt.name,
                               mod.name, mod.file, stmt)
                for b in stmt.bases:
                    if isinstance(b, ast.Name):
                        ci.base_names.append(b.id)
                    else:
                        chain = _attr_chain(b)
                        if chain:
                            ci.base_names.append(chain[-1])
                self._scan_class_body(mod, ci)
                self.classes[ci.qualname] = ci
        # map methods to classes
        for qual, info in self.lint.funcs.items():
            local = qual.split(":", 1)[1]
            if "." in local:
                clsname = local.rsplit(".", 1)[0]
                ci = self.classes.get(f"{info.module}:{clsname}")
                if ci is not None:
                    self.method_class[qual] = ci
                    ci.methods.setdefault(local.rsplit(".", 1)[1], qual)

    def _scan_class_body(self, mod, ci: ClassInfo):
        for n in ast.walk(ci.node):
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        ci.stores.add(t.attr)
                        ctor = self._ctor_of(mod, n.value)
                        if ctor is None:
                            continue
                        src, name = ctor
                        if src == "threading" and name in _LOCK_CTORS:
                            ci.lock_attrs[t.attr] = _LOCK_CTORS[name]
                            if name == "Condition" and n.value.args:
                                a0 = n.value.args[0]
                                if isinstance(a0, ast.Attribute) and \
                                        isinstance(a0.value, ast.Name) and \
                                        a0.value.id == "self":
                                    ci.lock_alias[t.attr] = a0.attr
                        elif src == "queue" and name in _QUEUE_CTORS:
                            ci.queue_attrs.add(t.attr)
            elif isinstance(n, (ast.AugAssign,)):
                t = n.target
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and t.value.id == "self":
                    ci.stores.add(t.attr)
            elif isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    e = item.context_expr
                    if isinstance(e, ast.Attribute) and \
                            isinstance(e.value, ast.Name) and \
                            e.value.id == "self":
                        ci.lock_attrs.setdefault(e.attr, "unknown")

    # -- lock identity --------------------------------------------------------
    def _mro(self, ci: ClassInfo) -> list:
        out, seen, stack = [], set(), [ci]
        while stack:
            c = stack.pop(0)
            if c.qualname in seen:
                continue
            seen.add(c.qualname)
            out.append(c)
            for b in c.base_names:
                # same module first, then any analyzed module
                cand = self.classes.get(f"{c.module}:{b}")
                if cand is None:
                    for q, other in self.classes.items():
                        if other.name == b:
                            cand = other
                            break
                if cand is not None:
                    stack.append(cand)
        return out

    def _canon_lock(self, ci: ClassInfo, attr: str) -> tuple | None:
        """(node id, kind) for a class lock attr, alias- and
        inheritance-resolved; None when the attr is no known lock."""
        mro = self._mro(ci)
        seen = set()
        while attr not in seen:
            seen.add(attr)
            nxt = None
            for c in mro:
                if attr in c.lock_alias:
                    nxt = c.lock_alias[attr]
                    break
            if nxt is None:
                break
            attr = nxt
        kind = None
        for c in mro:
            k = c.lock_attrs.get(attr)
            if k and k != "unknown":
                kind = k
                break
            if k and kind is None:
                kind = k
        if kind is None:
            return None
        owner = ci
        for c in reversed(mro):      # most basal class that assigns it
            if attr in c.stores or attr in c.lock_attrs:
                owner = c
                break
        node = f"{owner.qualname}.{attr}"
        self.lock_kinds.setdefault(node, kind)
        return node, kind

    def _class_lock_nodes(self, ci: ClassInfo) -> frozenset:
        out = set()
        for c in self._mro(ci):
            for attr in c.lock_attrs:
                lk = self._canon_lock(ci, attr)
                if lk:
                    out.add(lk[0])
        return frozenset(out)

    def _module_lock_nodes(self, module: str) -> frozenset:
        locks = self.module_locks.get(module, {})
        out = set()
        for name, kind in locks.items():
            node = f"{module}:<module>.{name}"
            self.lock_kinds.setdefault(node, kind)
            out.add(node)
        return frozenset(out)

    def _lock_node_of(self, cls, info, expr) -> tuple | None:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            if cls is None:
                return None
            return self._canon_lock(cls, expr.attr)
        if isinstance(expr, ast.Name):
            locks = self.module_locks.get(info.module, {})
            if expr.id in locks:
                node = f"{info.module}:<module>.{expr.id}"
                self.lock_kinds.setdefault(node, locks[expr.id])
                return node, locks[expr.id]
        return None

    # -- thread targets -------------------------------------------------------
    def _is_thread_ctor(self, mod, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Name):
            return mod.from_imports.get(f.id) == ("threading", "Thread")
        chain = _attr_chain(f)
        return bool(chain) and len(chain) >= 2 and \
            mod.module_imports.get(chain[0]) == "threading" and \
            chain[-1] == "Thread"

    def _collect_thread_targets(self):
        for qual, info in self.lint.funcs.items():
            mod = self.lint.modules[info.module]
            cls = self.method_class.get(qual)
            for n in ast.walk(info.node):
                if not (isinstance(n, ast.Call)
                        and self._is_thread_ctor(mod, n)):
                    continue
                tgt_expr = None
                for kw in n.keywords:
                    if kw.arg == "target":
                        tgt_expr = kw.value
                if tgt_expr is None and n.args:
                    tgt_expr = n.args[0]
                if tgt_expr is None:
                    continue
                # the target may be conditional (http vs jsonl reader):
                # resolve every self-attr / bare name inside the expr
                found = False
                for e in ast.walk(tgt_expr):
                    tq = None
                    if isinstance(e, ast.Attribute) and \
                            isinstance(e.value, ast.Name) and \
                            e.value.id == "self" and cls is not None:
                        for c in self._mro(cls):
                            if e.attr in c.methods:
                                tq = c.methods[e.attr]
                                break
                    elif isinstance(e, ast.Name):
                        hits = self.lint._resolve_in_module(mod, e.id)
                        tq = hits[0] if hits else None
                    if tq is not None:
                        self.thread_targets.append(
                            (tq, ast.dump(tgt_expr)[:60], info.file,
                             n.lineno))
                        found = True
                if not found:
                    self.thread_targets.append(
                        (None, ast.dump(tgt_expr)[:60], info.file, n.lineno))

    def analyzed_classes(self) -> set:
        """Class qualnames owning a lock or a queue field (directly or by
        inheritance) — the shared-state surface this pass reasons about."""
        out = set()
        for q, ci in self.classes.items():
            for c in self._mro(ci):
                if c.lock_attrs or c.queue_attrs:
                    out.add(q)
                    break
        return out

    def thread_target_coverage(self) -> tuple[list, list]:
        """(covered, uncovered) thread-target records; uncovered targets
        need an S4 justification entry in the baseline."""
        analyzed = self.analyzed_classes()
        covered, uncovered = [], []
        for tq, rep, file, line in self.thread_targets:
            rec = {"target": tq, "expr": rep, "file": file, "line": line}
            cls = self.method_class.get(tq) if tq else None
            if cls is not None and cls.qualname in analyzed:
                covered.append(rec)
            else:
                uncovered.append(rec)
        return covered, uncovered

    # -- entry-held fixpoint --------------------------------------------------
    def _confident_target(self, qual, func_expr) -> str | None:
        info = self.lint.funcs[qual]
        mod = self.lint.modules[info.module]
        if isinstance(func_expr, ast.Name):
            hits = self.lint._resolve_in_module(mod, func_expr.id)
            return hits[0] if len(hits) == 1 else None
        if isinstance(func_expr, ast.Attribute) and \
                isinstance(func_expr.value, ast.Name) and \
                func_expr.value.id in ("self", "cls"):
            cls = self.method_class.get(qual)
            if cls is not None:
                for c in self._mro(cls):
                    if func_expr.attr in c.methods:
                        return c.methods[func_expr.attr]
        return None

    def _init_entry(self):
        forced = {tq for tq, _r, _f, _l in self.thread_targets if tq}
        for qual, info in self.lint.funcs.items():
            cls = self.method_class.get(qual)
            name = info.name
            if cls is not None:
                if name == "__init__" or qual in forced:
                    self.entry[qual] = frozenset()
                elif name.endswith("_locked"):
                    self.entry[qual] = self._class_lock_nodes(cls)
                elif name.startswith("_") and not name.startswith("__"):
                    self.entry[qual] = None       # TOP: narrowed by fixpoint
                else:
                    self.entry[qual] = frozenset()
            else:
                if name.endswith("_locked"):
                    self.entry[qual] = self._module_lock_nodes(info.module)
                elif name.startswith("_") and not name.startswith("__") \
                        and not name.startswith("<"):
                    self.entry[qual] = None
                else:
                    self.entry[qual] = frozenset()

    def _fixpoint_entry(self):
        fix_vars = {q for q, v in self.entry.items() if v is None}
        for _ in range(10):
            sites: dict[str, list] = {}
            for qual, scan in self.scans.items():
                base = self.entry.get(qual)
                for cnode, local, _line in scan.calls:
                    tgt = self._confident_target(qual, cnode.func)
                    if tgt is None or tgt not in fix_vars:
                        continue
                    held = None if base is None else frozenset(base | local)
                    sites.setdefault(tgt, []).append(held)
            changed = False
            for tgt in fix_vars:
                known = [h for h in sites.get(tgt, []) if h is not None]
                if not known:
                    continue
                new = frozenset.intersection(*known)
                if self.entry[tgt] is None or self.entry[tgt] != new:
                    self.entry[tgt] = new
                    changed = True
            if not changed:
                break
        for q in fix_vars:                # never called confidently: entry
            if self.entry[q] is None:     # points are conservative
                self.entry[q] = frozenset()

    # -- shared call-resolution helpers --------------------------------------
    def _full_targets(self, qual, cnode) -> list:
        f = cnode.func
        if isinstance(f, ast.Attribute) and f.attr in _GENERIC_ATTRS:
            t = self._confident_target(qual, f)
            return [t] if t else []
        return self.lint._resolve_call(self.lint.funcs[qual], cnode.func)

    def _restricted_targets(self, qual, cnode) -> list:
        """Targets resolved confidently or by a UNIQUE bare name — the
        only resolutions trusted for transitive reasoning (device work,
        may-acquire closure); ambiguous bare names stay one-level."""
        tgts = self._full_targets(qual, cnode)
        if len(tgts) == 1:
            return tgts
        t = self._confident_target(qual, cnode.func)
        return [t] if t else []

    def _is_intraclass(self, qual, cnode) -> bool:
        f = cnode.func
        if not (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id in ("self", "cls")):
            return False
        cls = self.method_class.get(qual)
        if cls is None:
            return False
        return any(f.attr in c.methods for c in self._mro(cls))

    # -- blocking classification (S3) ----------------------------------------
    def _blocking_desc(self, qual, cnode, held) -> str | None:
        info = self.lint.funcs[qual]
        mod = self.lint.modules[info.module]
        f = cnode.func
        if isinstance(f, ast.Name):
            if f.id == "sleep" and f.id in mod.time_aliases:
                return "time.sleep()"
            src = mod.from_imports.get(f.id)
            if src and src[0] == "subprocess" and \
                    src[1] in _SUBPROCESS_CALLS:
                return f"subprocess.{src[1]}()"
            return None
        if not isinstance(f, ast.Attribute):
            return None
        chain = _attr_chain(f) or []
        attr = f.attr
        if chain and chain[0] in mod.time_aliases and attr == "sleep":
            return "time.sleep()"
        if chain and mod.module_imports.get(chain[0]) == "subprocess" and \
                attr in _SUBPROCESS_CALLS:
            return f"subprocess.{attr}()"
        if chain and chain[0] in (mod.torch_aliases | mod.torch_names):
            return f"direct torch dispatch ({'.'.join(chain)})"
        if attr in _BLOCKING_ATTRS:
            return f"socket/pipe I/O (.{attr}())"
        if attr == "join" and not cnode.args:
            return "blocking .join()"
        if attr == "get" and not cnode.args:
            return "blocking queue .get()"
        if attr == "wait":
            obj = f.value
            if isinstance(obj, ast.Attribute) and \
                    isinstance(obj.value, ast.Name) and \
                    obj.value.id == "self":
                cls = self.method_class.get(qual)
                lk = self._canon_lock(cls, obj.attr) if cls else None
                if lk is not None and lk[0] in held:
                    return None       # waiting on the held condition: legal
            if isinstance(obj, ast.Name):
                locks = self.module_locks.get(info.module, {})
                if obj.id in locks and \
                        f"{info.module}:<module>.{obj.id}" in held:
                    return None
            return "wait() on a foreign condition/event"
        return None

    # -- rule passes ----------------------------------------------------------
    def run(self):
        self._collect_classes()
        self._collect_thread_targets()
        for qual, info in self.lint.funcs.items():
            scan = _FuncScan(self, info, self.method_class.get(qual))
            body = (info.node.body if not isinstance(info.node, ast.Lambda)
                    else [info.node.body])
            for s in body:
                scan.visit(s)
            self.scans[qual] = scan
        self._init_entry()
        self._fixpoint_entry()
        self._rule_s1()
        self._rule_s2()
        self._rule_s3()
        self.violations.sort(key=lambda v: (v.file, v.line, v.rule))

    def _emit(self, qual, line, rule, msg):
        info = self.lint.funcs[qual]
        self.violations.append(SyncViolation(
            info.file, line, rule, qual.split(":", 1)[1], msg))

    def _held_at(self, qual, local) -> frozenset:
        base = self.entry.get(qual) or frozenset()
        return frozenset(base | local)

    def _rule_s1(self):
        field_acc: dict[tuple, list] = {}
        for qual, scan in self.scans.items():
            cls = self.method_class.get(qual)
            if cls is None:
                continue
            locks = self._class_lock_nodes(cls)
            if not locks:
                continue
            mro = self._mro(cls)
            excl = set()
            for c in mro:
                excl |= set(c.lock_attrs) | set(c.lock_alias) | c.queue_attrs
            info = self.lint.funcs[qual]
            in_init = info.name == "__init__"
            for attr, write, local, line in scan.accesses:
                if attr in excl:
                    continue
                owner = cls
                for c in reversed(mro):
                    if attr in c.stores:
                        owner = c
                        break
                held = self._held_at(qual, local)
                field_acc.setdefault((owner.qualname, attr), []).append(
                    (write, bool(held & locks), in_init, qual, line))
        for (_owner, attr), accs in sorted(field_acc.items()):
            guarded_by = [a for a in accs if a[0] and a[1] and not a[2]]
            if not guarded_by:
                continue
            seen = set()
            for write, protected, in_init, qual, line in accs:
                if in_init or protected:
                    continue
                info = self.lint.funcs[qual]
                k = (info.file, line, attr)
                if k in seen:
                    continue
                seen.add(k)
                self._emit(qual, line, "S1",
                           f"unguarded {'write to' if write else 'read of'} "
                           f"guarded field 'self.{attr}' — "
                           f"{len(guarded_by)} other write(s) hold the "
                           "class lock; this access does not")

    def _direct_acquires(self, qual) -> set:
        return {node for _h, node, _k, _l in self.scans[qual].acquires}

    def _may_acquire(self) -> dict:
        """Transitive lock-acquisition closure over confidently / uniquely
        resolved calls (ambiguous bare names are excluded: a spurious
        deep edge is how over-approximation manufactures fake cycles)."""
        ma = {q: set(self._direct_acquires(q)) for q in self.scans}
        rtgts = {}
        for qual, scan in self.scans.items():
            outs = set()
            for cnode, _local, _line in scan.calls:
                outs.update(self._restricted_targets(qual, cnode))
            rtgts[qual] = outs
        changed = True
        while changed:
            changed = False
            for q, outs in rtgts.items():
                for t in outs:
                    if t in ma and not ma[t] <= ma[q]:
                        ma[q] |= ma[t]
                        changed = True
        return ma

    def _rule_s2(self):
        edges: dict[tuple, tuple] = {}   # (a, b) -> (qual, line, via)

        def add_edge(a, b, qual, line, via):
            if a != b and (a, b) not in edges:
                edges[(a, b)] = (qual, line, via)

        ma = self._may_acquire()
        for qual, scan in self.scans.items():
            for local_before, node, kind, line in scan.acquires:
                held = self._held_at(qual, local_before)
                if node in held and kind == "Lock":
                    self._emit(qual, line, "S2",
                               f"re-acquiring non-reentrant lock {node} "
                               "already held — self-deadlock")
                for h in sorted(held):
                    add_edge(h, node, qual, line, "direct")
            for cnode, local, line in scan.calls:
                held = self._held_at(qual, local)
                if not held:
                    continue
                reach = set()
                for t in self._full_targets(qual, cnode):
                    if t in self.scans:
                        reach |= self._direct_acquires(t)
                for t in self._restricted_targets(qual, cnode):
                    reach |= ma.get(t, set())
                for h in sorted(held):
                    for a in sorted(reach):
                        add_edge(h, a, qual, line, "via call")
        # cycle detection (iterative DFS, deterministic order)
        graph: dict[str, list] = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
        for outs in graph.values():
            outs.sort()
        state: dict[str, int] = {}
        reported = set()

        def dfs(start):
            stack = [(start, iter(graph.get(start, ())))]
            path = [start]
            state[start] = 1
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if state.get(nxt, 0) == 1:
                        cyc = path[path.index(nxt):] + [nxt]
                        key = frozenset(cyc)
                        if key not in reported:
                            reported.add(key)
                            q, ln, _via = edges[(node, nxt)]
                            pretty = " -> ".join(
                                c.split(":", 1)[1] for c in cyc)
                            self._emit(q, ln, "S2",
                                       f"lock-order cycle: {pretty} — two "
                                       "threads taking these locks in "
                                       "opposite orders deadlock")
                        continue
                    if state.get(nxt, 0) == 0:
                        state[nxt] = 1
                        path.append(nxt)
                        stack.append((nxt, iter(graph.get(nxt, ()))))
                        advanced = True
                        break
                if not advanced:
                    state[node] = 2
                    stack.pop()
                    if path and path[-1] == node:
                        path.pop()

        for n in sorted(graph):
            if state.get(n, 0) == 0:
                dfs(n)

    def _rule_s3(self):
        # per-function direct blocking ops (held or not) for the
        # one-level transitive check at held call sites
        direct_block: dict[str, list] = {}
        for qual, scan in self.scans.items():
            out = []
            for cnode, local, line in scan.calls:
                held = self._held_at(qual, local)
                d = self._blocking_desc(qual, cnode, held)
                if d:
                    out.append((d, line))
            direct_block[qual] = out
        for qual, scan in self.scans.items():
            seen = set()
            for cnode, local, line in scan.calls:
                held = self._held_at(qual, local)
                if not held:
                    continue
                lock = sorted(held)[0].split(":", 1)[1]
                d = self._blocking_desc(qual, cnode, held)
                if d and ("direct", d) not in seen:
                    seen.add(("direct", d))
                    self._emit(qual, line, "S3",
                               f"{d} while holding {lock}")
                if self._is_intraclass(qual, cnode):
                    continue    # the callee is analyzed with inherited held
                for t in self._restricted_targets(qual, cnode):
                    if t in self.lint.torch_touch and \
                            ("device", t) not in seen:
                        seen.add(("device", t))
                        self._emit(qual, line, "S3",
                                   f"call into {t.split(':', 1)[1]} "
                                   f"launches device work while holding "
                                   f"{lock}")
                for t in self._full_targets(qual, cnode):
                    for d2, _l2 in direct_block.get(t, ()):
                        if ("lvl1", t, d2) in seen:
                            continue
                        seen.add(("lvl1", t, d2))
                        self._emit(qual, line, "S3",
                                   f"call into {t.split(':', 1)[1]} "
                                   f"performs {d2} while holding {lock}")


# -- baseline + driver --------------------------------------------------------

@dataclasses.dataclass
class SyncResult:
    new: list
    baselined: list
    stale: list
    analyzer: SyncAnalyzer | None = None

    @property
    def ok(self) -> bool:
        return not self.new


def run_sync(paths: Iterable[str] | None = None,
             baseline: list | None = None,
             root: str | None = None) -> SyncResult:
    """Run the sync pass over ``paths`` (default: the package) against a
    baseline of justified exceptions (dicts with file/rule/qualname)."""
    root = root or REPO_ROOT
    lint = Linter()
    for f in collect_files(paths or DEFAULT_TARGETS, root):
        rel = os.path.relpath(f, root)
        if not any(rel.startswith(x + os.sep) for x in EXCLUDED):
            lint.add_file(f, relto=root)
    syntax_errors = [SyncViolation(v.file, v.line, "S1", v.qualname,
                                   v.message)
                     for v in lint.violations]   # add_file syntax errors
    lint.violations = []
    lint.build()
    an = SyncAnalyzer(lint)
    an.run()
    an.violations = syntax_errors + an.violations
    # S4 entries justify thread targets, which no run reports as findings
    return SyncResult(*split_baseline(an.violations, baseline or [],
                                      never_stale=("S4",)), an)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mfmsync",
        description="lock-discipline & shared-state static analysis of "
                    "mfm_tpu_torch (S1-S3)")
    add_gate_flags(ap, DEFAULT_TARGETS, DEFAULT_BASELINE)
    args = ap.parse_args(argv)
    res = run_sync(args.paths, load_baseline(baseline_path(args)),
                   root=args.root)
    return report(res, "mfmsync", "finding", args.as_json, args.strict)


if __name__ == "__main__":
    sys.exit(main())
