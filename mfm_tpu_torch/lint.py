"""mfmlint — the port's doctrine as a static gate (counterpart of
``mfm_tpu/lint.py``).

The reference's rules, and what each means for eager PyTorch on the card:

  R1  no host-numpy compute inside traced code
  R2  integer dtypes in traced code must be explicit s32
  R4  no use of a donated argument after its donating call
  R7  no metrics/logging reachable from traced code
      — all four need a traced region (``jax.jit``, ``lax.scan``, ...) or
      buffer donation, and eager torch has neither: every call runs
      eagerly, integers keep the dtype they are given, and no buffer is
      handed to a callee.  The port keeps the IDs and emits none of them.
  R6  PartitionSpec axis names must come from the mesh doctrine: a
      string axis name in a call of ``PartitionSpec`` (imported under any
      alias, or ``parallel/mesh.py``'s short name ``P``) outside
      the axes ``parallel/mesh.py`` builds its ``Mesh`` over
      (``('date', 'stock')``).
  R3  process-global numeric switches only in designated entrypoint
      modules, and never the same switch to the same value twice per
      module: torch's TF32 flags (``torch.backends.cuda.matmul.allow_tf32``,
      ``torch.backends.cudnn.allow_tf32``, ``fp32_precision``),
      ``torch.set_float32_matmul_precision`` and
      ``torch.set_default_dtype``.  Legal in the counterparts of the
      reference's R3 modules: ``mfm_tpu_torch.cli``,
      ``mfm_tpu_torch.utils.prec`` (which turns TF32 off for the parity
      path), ``chip_smoke`` and ``mfm_tpu_torch.tools.*``.
  R5  a perf_counter span in ``chip_smoke`` or ``mfm_tpu_torch/tools``
      around work that reaches the card must synchronize inside the span
      (``torch.cuda.synchronize``, the smoke's ``sync``,
      ``utils/obs.force``, ``.item()``, ``.cpu()``, ``.tolist()``,
      ``.numpy()``): CUDA launches return before the kernels run, so an
      unforced span measures the enqueue.

The engine is the reference's: a conservative intra-package call graph
over the linted files, attribute calls resolved by bare method name
against every known def (over-approximate on purpose), with the
typed-receiver barriers for OS handles and builtin containers.  A
function *touches the device* when it calls into ``torch`` directly or
calls a function that does (fixed point); R5 and the sync pass's S3
(``mfm_tpu_torch/analysis/sync.py``) read that closure.

Intentional exceptions live in ``mfm_tpu_torch/tools/mfmlint_baseline.json``
keyed by (file, rule, function); ``--strict`` also fails on stale entries.

This module imports neither torch nor numpy: it is safe to run anywhere.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Iterable

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_TARGETS = ("mfm_tpu_torch", "chip_smoke.py")
DEFAULT_BASELINE = os.path.join("mfm_tpu_torch", "tools",
                                "mfmlint_baseline.json")

_NO_TRACE = ("eager torch has no traced region or buffer donation, so the "
             "port emits no finding under this rule")

RULES = {
    "R1": "host-numpy compute inside traced code — " + _NO_TRACE,
    "R2": "integer dtype in traced code must be explicit s32 — " + _NO_TRACE,
    "R3": "torch's process-global numeric switches (TF32 flags, "
          "set_float32_matmul_precision, set_default_dtype) only in "
          "designated entrypoint modules, never to the same value twice "
          "per module",
    "R4": "donated argument used after its donating call — " + _NO_TRACE,
    "R5": "perf_counter span times work that reaches the card without "
          "synchronizing inside it — the span measures the enqueue, not "
          "the compute",
    "R6": "PartitionSpec axis name outside the mesh doctrine "
          "(parallel/mesh.py's Mesh axes)",
    "R7": "metrics/logging call reachable from traced code — " + _NO_TRACE,
}

# modules (dotted) allowed to flip torch's process-global switches: the CLI
# and the smoke are entrypoints, utils/prec.py owns the parity path's TF32
# setting, and each tool under mfm_tpu_torch/tools is its own entrypoint
_R3_ALLOWED_MODULES = ("mfm_tpu_torch.cli", "mfm_tpu_torch.utils.prec",
                       "chip_smoke")
_R3_ALLOWED_PREFIXES = ("mfm_tpu_torch.tools.",)
#: attribute stores that flip a TF32 switch (whatever the receiver's name:
#: ``matmul = torch.backends.cuda.matmul; matmul.allow_tf32 = ...``)
_R3_FLAG_ATTRS = {"allow_tf32", "fp32_precision"}
#: calls that set a process-global default
_R3_CALLS = {"set_float32_matmul_precision", "set_default_dtype"}

# R5's scope: the standalone entry script and the port's tools
_R5_MODULES = ("chip_smoke",)
_R5_PREFIXES = ("mfm_tpu_torch.tools.",)

# calls that wait for the card's work on the host (R5)
_FORCING_NAMES = {"synchronize", "sync", "force", "item", "cpu", "tolist",
                  "numpy"}


def _attr_chain(node) -> list[str] | None:
    """a.b.c -> ['a', 'b', 'c']; None when the root isn't a plain Name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _const_str(node) -> str | None:
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


@dataclasses.dataclass
class Violation:
    file: str
    line: int
    rule: str
    qualname: str
    message: str

    def key(self) -> tuple:
        return (self.file, self.rule, self.qualname)

    def render(self) -> str:
        return (f"{self.file}:{self.line}: {self.rule} [{self.qualname}] "
                f"{self.message}\n    doctrine: {RULES[self.rule]}")


@dataclasses.dataclass
class FuncInfo:
    qualname: str            # module:Outer.inner or module:<lambda@L..>
    module: str
    name: str                # bare name ('' for lambdas)
    node: object             # ast.FunctionDef | ast.Lambda
    parent: str | None       # enclosing function qualname
    file: str


@dataclasses.dataclass
class ModuleInfo:
    name: str                # dotted module name
    file: str                # path as given (repo-relative when possible)
    tree: object
    # import alias sets
    np_aliases: set = dataclasses.field(default_factory=set)
    torch_aliases: set = dataclasses.field(default_factory=set)
    time_aliases: set = dataclasses.field(default_factory=set)
    functools_aliases: set = dataclasses.field(default_factory=set)
    # local names of ``PartitionSpec`` (R6)
    pspec_aliases: set = dataclasses.field(default_factory=set)
    # local name -> (target module, attr) for from-imports
    from_imports: dict = dataclasses.field(default_factory=dict)
    # local alias -> dotted module for module imports
    module_imports: dict = dataclasses.field(default_factory=dict)
    # names imported from torch or a torch submodule (``from torch import
    # nn``, ``from torch.profiler import profile``)
    torch_names: set = dataclasses.field(default_factory=set)
    # module-level defs: bare name -> qualname (methods as Class.meth)
    locals: dict = dataclasses.field(default_factory=dict)
    # class name -> attrs assigned from EXTERNAL handle constructors
    # (subprocess.Popen, socket.socket, open, .makefile()): method calls
    # through such a receiver (`self.proc.poll()`) are OS-handle I/O and
    # must never resolve into package defs via the bare-name fallback
    external_attrs: dict = dataclasses.field(default_factory=dict)
    # function qualname -> LOCAL names bound to external handles or builtin
    # containers (`fh = open(...)`, `with open(...) as fh`, `ev = {...}`):
    # the local form of the typed-receiver barrier
    external_fn_locals: dict = dataclasses.field(default_factory=dict)


def _is_torch_module(name: str) -> bool:
    return name == "torch" or name.startswith("torch.")


class _Scanner(ast.NodeVisitor):
    """Collect imports + every function (incl. nested and lambdas)."""

    def __init__(self, mod: ModuleInfo, funcs: dict, bare_index: dict):
        self.mod = mod
        self.funcs = funcs
        self.bare_index = bare_index
        self.scope: list[str] = []      # class/function name stack
        self.class_stack: list[str] = []  # enclosing ClassDef names only

    # -- imports ------------------------------------------------------------
    def visit_Import(self, node):
        for a in node.names:
            alias = a.asname or a.name.split(".")[0]
            tgt = a.name
            if tgt == "numpy":
                self.mod.np_aliases.add(alias)
            elif _is_torch_module(tgt):
                self.mod.torch_aliases.add(alias)
            elif tgt == "time":
                self.mod.time_aliases.add(alias)
            elif tgt == "functools":
                self.mod.functools_aliases.add(alias)
            else:
                self.mod.module_imports[alias] = tgt
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        src = node.module or ""
        for a in node.names:
            local = a.asname or a.name
            if _is_torch_module(src):
                self.mod.torch_names.add(local)
            elif src == "time":
                self.mod.time_aliases.add(local)
            elif a.name == "PartitionSpec" or (
                    src.endswith("parallel.mesh") and a.name == "P"):
                self.mod.pspec_aliases.add(local)
            else:
                self.mod.from_imports[local] = (src, a.name)
        self.generic_visit(node)

    # -- defs ---------------------------------------------------------------
    def _register(self, name: str, node):
        qual = f"{self.mod.name}:{'.'.join(self.scope + [name]) or name}"
        parent = None
        # nearest enclosing *function* (skip class frames)
        for i in range(len(self.scope) - 1, -1, -1):
            cand = f"{self.mod.name}:{'.'.join(self.scope[: i + 1])}"
            if cand in self.funcs:
                parent = cand
                break
        self.funcs[qual] = FuncInfo(qual, self.mod.name, name, node, parent,
                                    self.mod.file)
        if name and not name.startswith("<"):
            self.bare_index.setdefault(name, []).append(qual)
        if len(self.scope) == 0 or all(
                f"{self.mod.name}:{'.'.join(self.scope[:i + 1])}"
                not in self.funcs for i in range(len(self.scope))):
            # module-level def or method of a module-level class
            self.mod.locals.setdefault(name, qual)
        return qual

    def _visit_func(self, node, name):
        self._register(name, node)
        self.scope.append(name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_FunctionDef(self, node):
        self._visit_func(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._visit_func(node, node.name)

    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()
        self.scope.pop()

    def visit_Lambda(self, node):
        self._visit_func(node, f"<lambda@L{node.lineno}>")

    def _is_external_handle_ctor(self, call: ast.Call) -> bool:
        """subprocess.Popen / socket.* / open / .makefile() — constructors
        of OS handles whose methods (poll/wait/kill/recv/...) share bare
        names with half the package but can never be package calls."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id == "open":
                return True
            src = self.mod.from_imports.get(f.id)
            return bool(src and src[0] in ("subprocess", "socket"))
        chain = _attr_chain(f)
        if not chain:
            return False
        root, attr = chain[0], chain[-1]
        if attr == "makefile":
            return True
        tgt = self.mod.module_imports.get(root)
        if tgt == "subprocess" and attr == "Popen":
            return True
        return tgt == "socket" and attr in ("socket", "create_connection",
                                            "socketpair")

    _CONTAINER_CTORS = ("dict", "list", "set", "frozenset", "bytearray")

    def _is_builtin_container(self, value) -> bool:
        """Dict/list/set displays, comprehensions, and calls to the builtin
        container constructors — receivers whose methods can never be
        package calls."""
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                              ast.ListComp, ast.SetComp)):
            return True
        return (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in self._CONTAINER_CTORS
                and value.func.id not in self.mod.from_imports)

    def _current_func(self) -> str | None:
        for i in range(len(self.scope), 0, -1):
            q = f"{self.mod.name}:{'.'.join(self.scope[:i])}"
            if q in self.funcs:
                return q
        return None

    def _note_local_binding(self, name: str, external: bool) -> None:
        """Track (or, on rebind to anything else, untrack) a function-local
        name bound to an external handle / builtin container."""
        qual = self._current_func()
        if qual is None:
            return
        bound = self.mod.external_fn_locals.setdefault(qual, set())
        if external:
            bound.add(name)
        else:
            bound.discard(name)

    def visit_With(self, node):
        # `with open(tmp) as fh:` — fh.flush()/fh.write() are OS-handle
        # I/O, never package calls
        for item in node.items:
            if isinstance(item.optional_vars, ast.Name):
                self._note_local_binding(
                    item.optional_vars.id,
                    isinstance(item.context_expr, ast.Call)
                    and self._is_external_handle_ctor(item.context_expr))
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_Assign(self, node):
        # `phase1 = lambda ...` binds a function to a name: register the
        # lambda under that name so a call through it resolves
        if isinstance(node.value, ast.Lambda) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            self._visit_func(node.value, node.targets[0].id)
            return
        # `self.proc = subprocess.Popen(...)`: remember the attr as an
        # OS-handle receiver for the typed-receiver barrier
        if self.class_stack and isinstance(node.value, ast.Call) \
                and self._is_external_handle_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    self.mod.external_attrs.setdefault(
                        self.class_stack[-1], set()).add(t.attr)
        # `fh = open(...)` / `ev = {...}`: the local form of the same
        # barrier (rebinding to anything else untracks the name)
        external = (isinstance(node.value, ast.Call)
                    and self._is_external_handle_ctor(node.value)) \
            or self._is_builtin_container(node.value)
        for t in node.targets:
            if isinstance(t, ast.Name):
                self._note_local_binding(t.id, external)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None and isinstance(node.target, ast.Name):
            self._note_local_binding(
                node.target.id,
                (isinstance(node.value, ast.Call)
                 and self._is_external_handle_ctor(node.value))
                or self._is_builtin_container(node.value))
        self.generic_visit(node)


def _own_nodes(func_node) -> Iterable[ast.AST]:
    """Walk a function's body without descending into nested functions.

    Nested FunctionDef/Lambda nodes are yielded (so call sites can see them
    as arguments) but their bodies belong to their own FuncInfo.
    """
    if isinstance(func_node, ast.Lambda):
        roots = [func_node.body]
    else:
        roots = list(func_node.body)
    stack = list(roots)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


class Linter:
    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}
        self.funcs: dict[str, FuncInfo] = {}
        self.bare_index: dict[str, list[str]] = {}
        self.edges: dict[str, set[str]] = {}
        #: functions that (transitively) call into torch: device work
        self.torch_touch: set[str] = set()
        #: the mesh doctrine's axes (R6), read off parallel/mesh.py's
        #: ``Mesh(devices, (axes...))`` call when it is linted
        self.mesh_axes: set[str] = {"date", "stock"}
        self.violations: list[Violation] = []

    # -- loading ------------------------------------------------------------
    def add_file(self, path: str, relto: str | None = None):
        rel = os.path.relpath(path, relto or os.getcwd())
        modname = rel[:-3].replace(os.sep, ".").lstrip(".")
        while modname.startswith("."):
            modname = modname[1:]
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            self.violations.append(Violation(
                rel, e.lineno or 0, "R1", "<module>",
                f"syntax error prevents linting: {e.msg}"))
            return
        mod = ModuleInfo(modname, rel, tree)
        self.modules[modname] = mod
        _Scanner(mod, self.funcs, self.bare_index).visit(tree)

    # -- resolution ---------------------------------------------------------
    def _resolve_in_module(self, mod: ModuleInfo, name: str) -> list[str]:
        if name in mod.locals:
            return [mod.locals[name]]
        if name in mod.from_imports:
            src, attr = mod.from_imports[name]
            tgt = self.modules.get(src)
            if tgt and attr in tgt.locals:
                return [tgt.locals[attr]]
        return []

    def _resolve_call(self, caller: FuncInfo, func_node) -> list[str]:
        """Call target qualnames for a Call's func expression (conservative)."""
        mod = self.modules[caller.module]
        if isinstance(func_node, ast.Name):
            name = func_node.id
            # scope chain: nested defs of enclosing functions
            p = caller.qualname
            while p is not None:
                info = self.funcs.get(p)
                if info is None:
                    break
                cand = f"{p}.{name}"  # children qualnames are parent.child
                if cand in self.funcs:
                    return [cand]
                p = info.parent
            return self._resolve_in_module(mod, name)
        chain = _attr_chain(func_node)
        if not chain:
            return []
        root, attr = chain[0], chain[-1]
        # external API roots: never package calls
        if root in (mod.np_aliases | mod.torch_aliases | mod.time_aliases
                    | mod.functools_aliases | mod.torch_names):
            return []
        if root in mod.module_imports:
            tgt = self.modules.get(mod.module_imports[root])
            if tgt:
                return self._resolve_in_module(tgt, attr)
            return []
        if root in mod.from_imports:
            src, a = mod.from_imports[root]
            tgt = self.modules.get(f"{src}.{a}" if src else a)
            if tgt:
                return self._resolve_in_module(tgt, attr)
        # typed-receiver barrier: `self.proc.poll()` on a field assigned
        # from subprocess.Popen/socket/open is OS-handle I/O
        if root == "self" and len(chain) >= 3:
            cls_name = caller.qualname.split(":", 1)[1].split(".", 1)[0]
            ext = mod.external_attrs.get(cls_name)
            if ext and chain[1] in ext:
                return []
        # ... and its local form: `fh.flush()` / `ev.update(...)` where the
        # receiver was bound in this function (or an enclosing one) to an
        # open()/Popen/socket handle or a builtin container literal
        p = caller.qualname
        while p is not None:
            if root in mod.external_fn_locals.get(p, ()):
                return []
            info = self.funcs.get(p)
            p = info.parent if info is not None else None
        # bare-name over-approximation: any def in the lint set with this name
        return list(self.bare_index.get(attr, []))

    def _calls_torch(self, mod: ModuleInfo, call: ast.Call) -> bool:
        """A direct call into torch (``torch.x(...)``, a name imported
        from torch)."""
        f = call.func
        if isinstance(f, ast.Name):
            return f.id in mod.torch_names
        chain = _attr_chain(f)
        return bool(chain) and (chain[0] in mod.torch_aliases
                                or chain[0] in mod.torch_names)

    def _func_args_of_call(self, caller: FuncInfo, call: ast.Call):
        """Function-valued arguments of a call -> qualnames."""
        out = []
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, ast.Lambda):
                out.extend(q for q, info in self.funcs.items()
                           if info.node is arg)
            elif isinstance(arg, (ast.Name, ast.Attribute)):
                out.extend(self._resolve_call(caller, arg))
        return out

    # -- graph construction --------------------------------------------------
    def build(self):
        for qual, info in self.funcs.items():
            mod = self.modules[info.module]
            self.edges.setdefault(qual, set())
            for n in _own_nodes(info.node):
                if not isinstance(n, ast.Call):
                    continue
                tgts = self._resolve_call(info, n.func)
                self.edges[qual].update(tgts)
                if tgts:
                    # higher-order flow: a function-valued argument passed
                    # to a package function may be called by it — assume
                    # it is
                    fargs = self._func_args_of_call(info, n)
                    for t in tgts:
                        self.edges.setdefault(t, set()).update(fargs)
                if qual not in self.torch_touch and self._calls_torch(mod, n):
                    self.torch_touch.add(qual)

        # torch_touch: F touches the device if it calls a toucher (fixpoint)
        changed = True
        while changed:
            changed = False
            for q, outs in self.edges.items():
                if q not in self.torch_touch and outs & self.torch_touch:
                    self.torch_touch.add(q)
                    changed = True

    # -- rules ---------------------------------------------------------------
    def _emit(self, info: FuncInfo, node, rule: str, msg: str):
        self.violations.append(Violation(
            info.file, getattr(node, "lineno", 0), rule,
            info.qualname.split(":", 1)[1], msg))

    def _r3_switches(self, mod: ModuleInfo):
        """(node, switch, value key) for each flip of a process-global
        numeric switch in ``mod``."""
        for n in ast.walk(mod.tree):
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                value = n.value
                for t in targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    for e in elts:
                        if isinstance(e, ast.Attribute) and \
                                e.attr in _R3_FLAG_ATTRS:
                            chain = _attr_chain(e)
                            name = ".".join(chain) if chain else e.attr
                            key = (ast.dump(value) if len(elts) == 1
                                   and isinstance(value, ast.Constant)
                                   else None)
                            yield n, name, key
            elif isinstance(n, ast.Call):
                chain = _attr_chain(n.func) or []
                if isinstance(n.func, ast.Name):
                    name = n.func.id
                    is_torch = name in mod.torch_names
                else:
                    name = chain[-1] if chain else ""
                    is_torch = bool(chain) and chain[0] in mod.torch_aliases
                if not (is_torch and name in _R3_CALLS):
                    continue
                arg = n.args[0] if n.args else None
                key = None
                if isinstance(arg, ast.Constant):
                    key = ast.dump(arg)
                elif arg is not None and _attr_chain(arg):
                    key = ".".join(_attr_chain(arg))
                yield n, name, key

    def _check_r3(self, mod: ModuleInfo):
        allowed = (mod.name in _R3_ALLOWED_MODULES
                   or mod.name.startswith(_R3_ALLOWED_PREFIXES)
                   or mod.name.split(".")[-1] == "conftest")
        seen: dict[tuple, int] = {}
        for n, name, key in self._r3_switches(mod):
            qual = self._enclosing_qual(mod, n)
            if not allowed:
                self.violations.append(Violation(
                    mod.file, n.lineno, "R3", qual,
                    f"{name} set outside designated entrypoint modules "
                    f"({', '.join(_R3_ALLOWED_MODULES)}, "
                    "mfm_tpu_torch/tools/*)"))
                continue
            if key is None:
                continue
            k = (name, key)
            seen[k] = seen.get(k, 0) + 1
            if seen[k] > 1:
                self.violations.append(Violation(
                    mod.file, n.lineno, "R3", qual,
                    f"{name} set to the same value twice in one module — "
                    "the second setting is dead weight"))

    def _enclosing_qual(self, mod: ModuleInfo, node) -> str:
        best, best_span = "<module>", None
        for q, info in self.funcs.items():
            if info.module != mod.name:
                continue
            fn = info.node
            end = getattr(fn, "end_lineno", fn.lineno)
            if fn.lineno <= node.lineno <= end:
                span = end - fn.lineno
                if best_span is None or span < best_span:
                    best, best_span = q.split(":", 1)[1], span
        return best

    def _check_r5(self, info: FuncInfo):
        mod = self.modules[info.module]
        if not (mod.name in _R5_MODULES or mod.name.startswith(_R5_PREFIXES)):
            return
        pcs, forcing, device = [], [], []
        for n in _own_nodes(info.node):
            if not isinstance(n, ast.Call):
                continue
            chain = _attr_chain(n.func) or []
            if isinstance(n.func, ast.Name):
                name = n.func.id
            elif isinstance(n.func, ast.Attribute):
                name = n.func.attr   # covers torch.sum(x).item()
            else:
                name = ""
            if name == "perf_counter" and (not chain
                                           or chain[0] in mod.time_aliases):
                pcs.append(n.lineno)
            elif name in _FORCING_NAMES:
                forcing.append(n.lineno)
            elif self._calls_torch(mod, n):
                device.append(n.lineno)
            else:
                for t in self._resolve_call(info, n.func):
                    if t in self.torch_touch:
                        device.append(n.lineno)
                        break
        if len(pcs) < 2:
            return
        lo, hi = min(pcs), max(pcs)
        spans_device = [ln for ln in device if lo <= ln <= hi]
        if spans_device and not any(lo <= ln <= hi for ln in forcing):
            self._emit(info, info.node, "R5",
                       f"perf_counter span (lines {lo}-{hi}) contains work "
                       "that reaches the card without a synchronize inside "
                       "the span")

    def _read_mesh_axes(self):
        for mod in self.modules.values():
            if not mod.name.endswith("parallel.mesh"):
                continue
            for n in ast.walk(mod.tree):
                if not isinstance(n, ast.Call):
                    continue
                chain = _attr_chain(n.func) or []
                if chain[-1:] == ["Mesh"] and len(n.args) >= 2 and \
                        isinstance(n.args[1], (ast.Tuple, ast.List)):
                    axes = {_const_str(e) for e in n.args[1].elts}
                    axes.discard(None)
                    if axes:
                        self.mesh_axes = axes

    def _check_r6(self, mod: ModuleInfo):
        aliases = set(mod.pspec_aliases)
        if mod.name.endswith("parallel.mesh"):
            aliases |= {"PartitionSpec", "P"}   # the module's own names
        if not aliases:
            return
        for n in ast.walk(mod.tree):
            if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id in aliases):
                continue
            for a in n.args:
                elts = a.elts if isinstance(a, (ast.Tuple, ast.List)) else [a]
                for e in elts:
                    s = _const_str(e)
                    if s is not None and s not in self.mesh_axes:
                        self.violations.append(Violation(
                            mod.file, n.lineno, "R6",
                            self._enclosing_qual(mod, n),
                            f"PartitionSpec axis {s!r} is not a doctrine "
                            f"mesh axis {sorted(self.mesh_axes)}"))

    def run_rules(self):
        self._read_mesh_axes()
        for info in self.funcs.values():
            self._check_r5(info)
        for mod in self.modules.values():
            self._check_r3(mod)
            self._check_r6(mod)
        self.violations.sort(key=lambda v: (v.file, v.line, v.rule))


# -- baseline + driver -------------------------------------------------------

def load_baseline(path: str | None) -> list[dict]:
    if not path or not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class LintResult:
    new: list[Violation]
    baselined: list[Violation]
    stale: list[dict]

    @property
    def ok(self) -> bool:
        return not self.new


def collect_files(paths: Iterable[str], root: str) -> list[str]:
    out = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames) if f.endswith(".py"))
        elif full.endswith(".py"):
            out.append(full)
    return out


def split_baseline(found: list, baseline: list[dict],
                   never_stale=()) -> tuple[list, list, list[dict]]:
    """(new, baselined, stale) of ``found`` against ``baseline`` entries
    keyed by (file, rule, qualname); entries of a rule in ``never_stale``
    are not reported stale."""
    bl_keys = {(b["file"], b["rule"], b["qualname"]) for b in baseline}
    new = [v for v in found if v.key() not in bl_keys]
    old = [v for v in found if v.key() in bl_keys]
    hit = {v.key() for v in old}
    stale = [b for b in baseline if b["rule"] not in never_stale
             and (b["file"], b["rule"], b["qualname"]) not in hit]
    return new, old, stale


def run_lint(paths: Iterable[str], baseline: list[dict] | None = None,
             root: str | None = None) -> LintResult:
    """Lint ``paths`` (files or directories) against the doctrine rules.

    ``root`` anchors module-name derivation (defaults to the repo root);
    ``baseline`` entries are dicts with file/rule/qualname keys.
    """
    root = root or REPO_ROOT
    lint = Linter()
    for f in collect_files(paths, root):
        lint.add_file(f, relto=root)
    lint.build()
    lint.run_rules()
    return LintResult(*split_baseline(lint.violations, baseline or []))


def report(res, tool: str, what: str, as_json: bool, strict: bool) -> int:
    """Print a lint or sync result and return the exit code: 1 on new
    findings, or on stale baseline entries under ``strict``."""
    if as_json:
        print(json.dumps({
            "new": [dataclasses.asdict(v) for v in res.new],
            "baselined": [dataclasses.asdict(v) for v in res.baselined],
            "stale": res.stale,
        }, indent=1))
    else:
        for v in res.new:
            print(v.render())
        for b in res.stale:
            print(f"STALE baseline entry: {b['file']} {b['rule']} "
                  f"[{b['qualname']}] — the {what} no longer exists; "
                  "remove it")
        print(f"{tool}: {len(res.new)} new {what}(s), "
              f"{len(res.baselined)} baselined, {len(res.stale)} stale "
              "baseline entr(ies)")
    if res.new or (strict and res.stale):
        return 1
    return 0


def add_gate_flags(ap, targets: tuple, baseline: str) -> None:
    """The flags ``mfmlint`` and ``mfmsync`` share."""
    ap.add_argument("paths", nargs="*", default=list(targets),
                    help=f"files/dirs to analyze (default: "
                         f"{' '.join(targets)})")
    ap.add_argument("--baseline", default=baseline,
                    help="baseline JSON of justified findings "
                         "('none' disables)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="root for module-name derivation (default: repo)")


def baseline_path(args) -> str | None:
    if args.baseline.lower() == "none":
        return None
    return (args.baseline if os.path.isabs(args.baseline)
            else os.path.join(args.root, args.baseline))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mfmlint",
        description="AST lint for the port's doctrine (R3, R5, R6; R1, R2, "
                    "R4 and R7 need a traced region or donation)")
    add_gate_flags(ap, DEFAULT_TARGETS, DEFAULT_BASELINE)
    args = ap.parse_args(argv)
    res = run_lint(args.paths, load_baseline(baseline_path(args)),
                   root=args.root)
    return report(res, "mfmlint", "violation", args.as_json, args.strict)


if __name__ == "__main__":
    sys.exit(main())
