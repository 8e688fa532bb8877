"""Intra-package call-graph engine for the whole-program lint rules
(counterpart of ``scaling_tpu/analysis/callgraph.py``).

The per-file AST pass (lint.py) sees one module at a time; the
concurrency and hot-path contract rules (STA009-STA011, concurrency.py)
need to answer *reachability* questions — "is this ``os.replace`` ever
executed under a ``retry_io`` wrapper?", "does the serve tick reach a
``torch.cuda.synchronize``?", "which methods run on the heartbeat thread?".
This module builds the graph those questions run over:

- every ``.py`` under the analyzed paths is parsed once; module dotted
  names derive from the path (``scaling_tpu_torch/serve/engine.py`` ->
  ``scaling_tpu_torch.serve.engine``), so relative imports resolve;
- functions are indexed by qualified name, including methods and
  *nested closures* (``worker`` inside ``_start_prefetch`` — thread
  targets are routinely closures);
- call edges resolve: module-level functions, imported package
  functions, ``self.method``, ``ClassName(...)`` constructors,
  ``self.attr.method(...)`` via attribute-type inference
  (``self.scheduler = ContinuousBatchingScheduler(...)`` in
  ``__init__`` types the attr), local-variable types
  (``x = ClassName(...)``), and module-aliased attributes
  (``self._torch = torch`` makes ``self._torch.cuda.synchronize``
  resolve to ``torch.cuda.synchronize``);
- calls that cannot be resolved statically (dict-of-programs dispatch,
  duck-typed parameters) are recorded as unresolved and never crash
  the analysis — soundness degrades to "unknown", not to an exception;
- ``threading.Thread(target=...)`` spawn sites are collected with
  their resolved targets: they are the thread entry points STA009
  partitions a class's methods by.

Best-effort by design: the graph under-approximates (unresolved
dynamic calls add no edges) — acceptable for lint rules whose
findings are triaged and annotated, wrong for anything that must be
complete. No torch import; pure stdlib ``ast``.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

# attribute chains on these roots never resolve further (runtime objects)
_UNRESOLVED = None


def _iter_py_files(paths: Iterable[Path | str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    return files


def module_dotted_name(rel: str) -> str:
    """``scaling_tpu_torch/serve/engine.py`` -> ``scaling_tpu_torch.serve.engine``;
    package ``__init__.py`` maps to the package itself."""
    parts = Path(rel).with_suffix("").parts
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _ImportMap:
    """Module-level name -> dotted target, with RELATIVE imports
    resolved against the module's own dotted name (lint's ``_Aliases``
    skips them; the call graph cannot — ``from .scheduler import X``
    is how the package wires itself together)."""

    def __init__(self, tree: ast.Module, modname: str,
                 is_package: bool = False):
        self.map: Dict[str, str] = {}
        pkg_parts = modname.split(".") if modname else []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.map[a.asname] = a.name
                    else:
                        self.map[a.name.split(".")[0]] = a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0:
                    base = node.module or ""
                else:
                    # relative: strip (level) trailing components of the
                    # IMPORTING module's dotted path — one fewer for a
                    # package __init__, whose modname IS its package —
                    # then append node.module
                    strip = node.level - 1 if is_package else node.level
                    up = pkg_parts[: len(pkg_parts) - strip] \
                        if strip <= len(pkg_parts) else []
                    base = ".".join(up + ([node.module] if node.module else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    target = f"{base}.{a.name}" if base else a.name
                    self.map[a.asname or a.name] = target

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain through the imports."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return _UNRESOLVED
        root = self.map.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))


@dataclasses.dataclass
class FunctionInfo:
    qualname: str  # "<modname>:<Class>.<method>" / "<modname>:<fn>.<locals>.<inner>"
    name: str  # simple name
    dotted: str  # class-qualified suffix, e.g. "ServeEngine.tick" or "fn"
    module: "ModuleInfo"
    node: ast.AST
    class_name: Optional[str] = None
    parent: Optional[str] = None  # enclosing function qualname (closures)
    is_traced: bool = False  # compiled: torch.compile, torch.jit, a Triton jit

    def __repr__(self) -> str:  # compact for test failure output
        return f"<fn {self.qualname}>"


@dataclasses.dataclass
class ClassInfo:
    name: str
    qualname: str  # "<modname>:<Class>"
    dotted: str  # "<modname>.<Class>"
    module: "ModuleInfo"
    node: ast.ClassDef
    methods: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    # self.<attr> = ClassName(...)  ->  attr -> ClassInfo.dotted
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    # self.<attr> = <module>  ->  attr -> module dotted name ("torch", "numpy")
    attr_modules: Dict[str, str] = dataclasses.field(default_factory=dict)
    # self.<attr> = self.<method>  ->  attr -> method simple name (a
    # self-stored callback: ``self._cb = self._on_done; self._cb()``)
    attr_callbacks: Dict[str, str] = dataclasses.field(default_factory=dict)
    bases: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModuleInfo:
    path: Path
    rel: str
    modname: str
    tree: ast.Module
    source: str
    imports: _ImportMap
    functions: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ThreadSpawn:
    """One ``threading.Thread(target=...)`` site."""

    function: FunctionInfo  # the spawning function
    target: Optional[FunctionInfo]  # resolved entry point (None = dynamic)
    node: ast.Call


# compilers whose function argument (or decorated function) runs off the
# eager interpreter: torch.compile, torch.jit.script / trace, and Triton's
# jit and autotune (device code, where a host sync cannot occur)
_TRACING_TAILS = ("compile", "script", "trace", "jit", "autotune", "heuristics")


def own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested ``def``s or
    classes (each nested function is its own graph node). Lambdas ARE
    descended into: they are never indexed as graph nodes of their own,
    so their bodies — callback I/O, a sync hidden in a key function —
    belong to the enclosing function or the rules never see them."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class CallGraph:
    """The package-wide graph: functions, classes, call edges, thread
    spawn sites, and reachability over them."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}  # modname -> info
        self.functions: Dict[str, FunctionInfo] = {}  # qualname -> info
        # global lookups
        self._by_dotted: Dict[str, FunctionInfo] = {}  # modname.Class.meth / modname.fn
        self.classes: Dict[str, ClassInfo] = {}  # dotted -> info
        self.edges: Dict[str, Set[str]] = {}  # caller qualname -> callees
        self.unresolved: Dict[str, List[ast.Call]] = {}  # caller -> dynamic calls
        self.thread_spawns: List[ThreadSpawn] = []
        # abstract method qualname -> override qualnames in subclasses.
        # Kept SEPARATE from ``edges``: the concurrency rules
        # (STA009-STA011) are pinned on exact static edges; the protocol
        # rules opt in via ``descendants(..., virtual=True)`` so a call
        # on the abstract ControlPlane surface flows into both backends.
        self.override_edges: Dict[str, Set[str]] = {}
        self._local_types_cache: Dict[str, Dict[str, str]] = {}
        self._alias_cache: Dict[str, Dict[str, str]] = {}

    # -------------------------------------------------------------- build
    @classmethod
    def build(cls, paths: Iterable[Path | str],
              root: Optional[Path | str] = None) -> "CallGraph":
        root = Path(root) if root else Path.cwd()
        graph = cls()
        for f in _iter_py_files(paths):
            try:
                rel = str(f.resolve().relative_to(root.resolve()))
            except ValueError:
                rel = str(f)
            try:
                source = f.read_text()
                tree = ast.parse(source, filename=str(f))
            except (SyntaxError, OSError):
                continue  # per-file lint reports syntax errors; skip here
            modname = module_dotted_name(rel)
            mod = ModuleInfo(
                path=f, rel=rel, modname=modname, tree=tree, source=source,
                imports=_ImportMap(tree, modname,
                                   is_package=f.name == "__init__.py"),
            )
            graph.modules[modname] = mod
            graph._index_module(mod)
        graph._infer_attr_types()
        graph._resolve_calls()
        graph._infer_overrides()
        return graph

    # ---------------------------------------------------------- indexing
    def _register(self, fn: FunctionInfo) -> None:
        self.functions[fn.qualname] = fn
        self._by_dotted.setdefault(
            f"{fn.module.modname}.{fn.dotted}" if fn.module.modname
            else fn.dotted,
            fn,
        )

    def _index_module(self, mod: ModuleInfo) -> None:
        def index_function(node, dotted_prefix: str, class_name, parent):
            dotted = (f"{dotted_prefix}.{node.name}" if dotted_prefix
                      else node.name)
            qual = f"{mod.modname}:{dotted}"
            fn = FunctionInfo(
                qualname=qual, name=node.name, dotted=dotted, module=mod,
                node=node, class_name=class_name, parent=parent,
            )
            fn.is_traced = self._decorated_traced(mod, node)
            self._register(fn)
            if class_name is None or parent is not None:
                mod.functions[dotted] = fn
            # nested defs (closures): graph nodes of their own
            for child in ast.walk(node):
                if child is node:
                    continue
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if self._enclosing_def(node, child) is node:
                        index_function(child, dotted, class_name, qual)
            return fn

        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                index_function(node, "", None, None)
            elif isinstance(node, ast.ClassDef):
                cinfo = ClassInfo(
                    name=node.name, qualname=f"{mod.modname}:{node.name}",
                    dotted=(f"{mod.modname}.{node.name}" if mod.modname
                            else node.name),
                    module=mod, node=node,
                    bases=[mod.imports.resolve(b) or "" for b in node.bases],
                )
                mod.classes[node.name] = cinfo
                self.classes[cinfo.dotted] = cinfo
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        fn = index_function(item, node.name, node.name, None)
                        cinfo.methods[item.name] = fn

    @staticmethod
    def _enclosing_def(outer: ast.AST, target: ast.AST) -> Optional[ast.AST]:
        """The innermost function whose body (transitively, through
        non-function nodes) contains ``target``."""
        result = [None]

        def walk(node, current):
            for child in ast.iter_child_nodes(node):
                if child is target:
                    result[0] = current
                    return
                nxt = child if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) else current
                walk(child, nxt)

        walk(outer, outer)
        return result[0]

    def _decorated_traced(self, mod: ModuleInfo, node) -> bool:
        decs = getattr(node, "decorator_list", [])
        for d in decs:
            target = d.func if isinstance(d, ast.Call) else d
            name = mod.imports.resolve(target)
            if name and name.rsplit(".", 1)[-1] in _TRACING_TAILS:
                return True
            if isinstance(d, ast.Call):
                fn = mod.imports.resolve(d.func)
                if fn in ("functools.partial", "partial") and d.args:
                    inner = mod.imports.resolve(d.args[0])
                    if inner and inner.rsplit(".", 1)[-1] in _TRACING_TAILS:
                        return True
        return False

    # --------------------------------------------------- attribute typing
    def _follow_export(self, dotted: Optional[str], depth: int = 0
                       ) -> Optional[str]:
        """Resolve a dotted name through package re-exports: a name
        imported from ``scaling_tpu_torch.resilience`` may be DEFINED in
        ``scaling_tpu_torch.resilience.commit`` and re-exported by the
        package ``__init__`` — follow that chain to the definition."""
        if not dotted or depth > 4:
            return dotted
        if dotted in self.classes or dotted in self._by_dotted:
            return dotted
        if "." not in dotted:
            return dotted
        prefix, name = dotted.rsplit(".", 1)
        pkg = self.modules.get(prefix)
        if pkg is None:
            return dotted
        target = pkg.imports.map.get(name)
        if target and target != dotted:
            return self._follow_export(target, depth + 1)
        return dotted

    def _lookup_class(self, mod: ModuleInfo, name: Optional[str]
                      ) -> Optional[ClassInfo]:
        if not name:
            return None
        if name in mod.classes:  # same module, simple name
            return mod.classes[name]
        dotted = mod.imports.resolve(ast.Name(id=name)) if "." not in name \
            else name
        dotted = self._follow_export(dotted)
        if dotted and dotted in self.classes:
            return self.classes[dotted]
        # imported: resolve "pkg.mod.Class" directly
        if name in self.classes:
            return self.classes[name]
        return None

    def _value_class(self, mod: ModuleInfo, value: ast.AST
                     ) -> Optional[ClassInfo]:
        """The ClassInfo an expression constructs, if resolvable."""
        if isinstance(value, ast.Call):
            name = self._follow_export(mod.imports.resolve(value.func))
            if name and name in self.classes:
                return self.classes[name]
            if name and "." not in name:
                return self._lookup_class(mod, name)
            # imported-from: map alias through imports
            if isinstance(value.func, ast.Name):
                dotted = self._follow_export(
                    mod.imports.map.get(value.func.id)
                )
                if dotted and dotted in self.classes:
                    return self.classes[dotted]
        return None

    def _annotation_class(self, mod: ModuleInfo, ann: ast.AST
                          ) -> Optional[ClassInfo]:
        """The ClassInfo an annotation names — ``Foo``, ``"Foo"``,
        ``mod.Foo``, ``Optional[Foo]`` (one peel). Feeds the
        ``self.x = <annotated param>`` attr-typing below: constructor
        injection (``def __init__(self, client: ReplicaProcClient)``)
        is how this codebase wires the protocol objects together, and
        without it every RPC/barrier call through an injected handle
        is a resolution dead end."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):
            base = ann.value
            base_name = base.attr if isinstance(base, ast.Attribute) \
                else getattr(base, "id", None)
            if base_name == "Optional":
                return self._annotation_class(mod, ann.slice)
            return None
        if isinstance(ann, ast.Attribute):
            dotted = self._follow_export(mod.imports.resolve(ann))
            if dotted and dotted in self.classes:
                return self.classes[dotted]
            return None
        if isinstance(ann, ast.Name):
            return self._lookup_class(mod, ann.id)
        return None

    def _infer_attr_types(self) -> None:
        """``self.x = ClassName(...)`` types attr ``x``; ``self.x = torch``
        (a module alias) records a module attr — both feed call and name
        resolution inside the class's methods."""
        for cinfo in self.classes.values():
            mod = cinfo.module
            for meth in cinfo.methods.values():
                margs = meth.node.args
                param_ann = {
                    a.arg: a.annotation
                    for a in (margs.posonlyargs + margs.args
                              + margs.kwonlyargs)
                    if a.annotation is not None
                }
                for node in ast.walk(meth.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    for tgt in node.targets:
                        if not (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                        ):
                            continue
                        attr = tgt.attr
                        klass = self._value_class(mod, node.value)
                        if klass is not None:
                            cinfo.attr_types.setdefault(attr, klass.dotted)
                            continue
                        # self.<attr> = self.<method>: a stored callback
                        # (``self._cb = self._on_done``) — later
                        # ``self._cb()`` calls resolve to the method
                        if (
                            isinstance(node.value, ast.Attribute)
                            and isinstance(node.value.value, ast.Name)
                            and node.value.value.id == "self"
                        ):
                            cinfo.attr_callbacks.setdefault(
                                attr, node.value.attr
                            )
                            continue
                        # self.<attr> = <param> where the parameter is
                        # class-annotated (constructor injection)
                        if (
                            isinstance(node.value, ast.Name)
                            and node.value.id in param_ann
                        ):
                            klass = self._annotation_class(
                                mod, param_ann[node.value.id]
                            )
                            if klass is not None:
                                cinfo.attr_types.setdefault(
                                    attr, klass.dotted
                                )
                                continue
                        if isinstance(node.value, ast.Name):
                            dotted = mod.imports.map.get(node.value.id)
                            if dotted and dotted not in self.classes and (
                                dotted.split(".")[0] not in self.modules
                                or dotted in self.modules
                            ):
                                # a module object handle (self._torch = torch)
                                cinfo.attr_modules.setdefault(attr, dotted)

    # ----------------------------------------------------- call resolution
    def resolve_name(self, fn: FunctionInfo, node: ast.AST) -> Optional[str]:
        """Dotted name of an expression, resolving local module aliases
        (``np = self._np``) and module-typed self attributes
        (``self._torch.cuda.synchronize`` -> ``torch.cuda.synchronize``)."""
        mod = fn.module
        cinfo = (mod.classes.get(fn.class_name)
                 if fn.class_name else None)
        # peel the attribute chain down to its root name
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return _UNRESOLVED
        root = cur.id
        chain = list(reversed(parts))
        if root == "self" and cinfo is not None and chain:
            if chain[0] in cinfo.attr_modules:
                return ".".join([cinfo.attr_modules[chain[0]]] + chain[1:])
            return _UNRESOLVED if len(chain) > 1 else None
        # local alias of a module-typed attribute: np = self._np
        alias = self._local_module_alias(fn, root)
        if alias is not None:
            return ".".join([alias] + chain)
        return mod.imports.resolve(node)

    def _local_module_alias(self, fn: FunctionInfo, name: str
                            ) -> Optional[str]:
        # One AST walk per function, memoized: resolve_name runs per
        # call site, and re-walking the body for every lookup turns the
        # whole-package pass quadratic (the analyzer's own wall budget
        # is pinned in tier-1).
        cached = self._alias_cache.get(fn.qualname)
        if cached is None:
            cached = {}
            cinfo = (fn.module.classes.get(fn.class_name)
                     if fn.class_name else None)
            if cinfo is not None and cinfo.attr_modules:
                for node in own_nodes(fn.node):
                    if (
                        isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Attribute)
                        and isinstance(node.value.value, ast.Name)
                        and node.value.value.id == "self"
                        and node.value.attr in cinfo.attr_modules
                    ):
                        cached.setdefault(
                            node.targets[0].id,
                            cinfo.attr_modules[node.value.attr],
                        )
            self._alias_cache[fn.qualname] = cached
        return cached.get(name)

    def _method_of(self, class_dotted: str, name: str
                   ) -> Optional[FunctionInfo]:
        """Method lookup with best-effort single-level base walk inside
        the package."""
        seen: Set[str] = set()
        stack = [class_dotted]
        while stack:
            d = stack.pop()
            if d in seen:
                continue
            seen.add(d)
            cinfo = self.classes.get(d)
            if cinfo is None:
                continue
            if name in cinfo.methods:
                return cinfo.methods[name]
            for b in cinfo.bases:
                if b:
                    if b in self.classes:
                        stack.append(b)
                    else:
                        # base named in the same module / simple name
                        k = self._lookup_class(cinfo.module, b.split(".")[-1])
                        if k is not None:
                            stack.append(k.dotted)
        return None

    def _local_types(self, fn: FunctionInfo) -> Dict[str, str]:
        """Local var -> class dotted, from ``x = ClassName(...)``,
        ``x = self.attr`` of a typed attribute, and parameter
        annotations naming a package class (``commit: CheckpointCommit``).

        Memoized per function: every rule that scans call sites asks for
        this map, and the answer is fixed once the graph is built — the
        cache turns the analyzer's dominant repeated AST walk into a
        dict hit (the STA009-STA014 passes share one graph per run)."""
        cached = self._local_types_cache.get(fn.qualname)
        if cached is not None:
            return cached
        out = self._local_types_uncached(fn)
        self._local_types_cache[fn.qualname] = out
        return out

    def _local_types_uncached(self, fn: FunctionInfo) -> Dict[str, str]:
        mod = fn.module
        cinfo = (mod.classes.get(fn.class_name)
                 if fn.class_name else None)
        out: Dict[str, str] = {}
        args = getattr(fn.node, "args", None)
        if args is not None:
            for a in (list(args.args) + list(args.posonlyargs)
                      + list(args.kwonlyargs)):
                ann = a.annotation
                if isinstance(ann, ast.Constant) and isinstance(ann.value,
                                                                str):
                    klass = self._lookup_class(mod, ann.value)
                elif isinstance(ann, (ast.Name, ast.Attribute)):
                    name = mod.imports.resolve(ann)
                    klass = (self.classes.get(name)
                             or self._lookup_class(mod, name)) if name \
                        else None
                else:
                    klass = None
                if klass is not None:
                    out[a.arg] = klass.dotted
        for node in own_nodes(fn.node):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            tgt = node.targets[0].id
            klass = self._value_class(mod, node.value)
            if klass is not None:
                out[tgt] = klass.dotted
            elif (
                cinfo is not None
                and isinstance(node.value, ast.Attribute)
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id == "self"
                and node.value.attr in cinfo.attr_types
            ):
                out[tgt] = cinfo.attr_types[node.value.attr]
        return out

    def resolve_callable(self, fn: FunctionInfo, func: ast.AST,
                         local_types: Optional[Dict[str, str]] = None
                         ) -> Optional[FunctionInfo]:
        """Resolve the callee expression of a Call in ``fn``'s body to a
        FunctionInfo, or None for dynamic/out-of-package calls."""
        mod = fn.module
        cinfo = (mod.classes.get(fn.class_name)
                 if fn.class_name else None)
        if local_types is None:
            local_types = self._local_types(fn)
        if isinstance(func, ast.Name):
            name = func.id
            # nested def in this function
            nested = self.functions.get(f"{fn.qualname}.{name}")
            if nested is None and fn.parent:
                nested = self.functions.get(f"{fn.parent}.{name}")
            if nested is not None:
                return nested
            # module-level function in the same module
            if name in mod.functions:
                return mod.functions[name]
            # class constructor
            klass = self._lookup_class(mod, name)
            if klass is not None:
                return klass.methods.get("__init__")
            # imported function from another analyzed module
            dotted = self._follow_export(mod.imports.map.get(name))
            if dotted:
                if dotted in self._by_dotted:
                    return self._by_dotted[dotted]
                if dotted in self.classes:
                    return self.classes[dotted].methods.get("__init__")
            return None
        if isinstance(func, ast.Attribute):
            # self.method(...)
            if isinstance(func.value, ast.Name) and func.value.id == "self" \
                    and cinfo is not None:
                m = self._method_of(cinfo.dotted, func.attr)
                if m is not None:
                    return m
                # self-stored callback: self._cb = self._on_done
                cb = cinfo.attr_callbacks.get(func.attr)
                if cb is not None:
                    return self._method_of(cinfo.dotted, cb)
                return None
            # self.attr.method(...) via attribute type
            if (
                isinstance(func.value, ast.Attribute)
                and isinstance(func.value.value, ast.Name)
                and func.value.value.id == "self"
                and cinfo is not None
                and func.value.attr in cinfo.attr_types
            ):
                return self._method_of(
                    cinfo.attr_types[func.value.attr], func.attr
                )
            # localvar.method(...) via local type
            if isinstance(func.value, ast.Name) \
                    and func.value.id in local_types:
                return self._method_of(local_types[func.value.id], func.attr)
            # module.function(...) from an analyzed module
            dotted = self._follow_export(self.resolve_name(fn, func))
            if dotted and dotted in self._by_dotted:
                return self._by_dotted[dotted]
            if dotted and dotted in self.classes:
                return self.classes[dotted].methods.get("__init__")
            return None
        return None

    def _resolve_spawn_target(self, fn: FunctionInfo, value: ast.AST,
                              local_types: Dict[str, str]
                              ) -> Optional[FunctionInfo]:
        """A ``Thread(target=...)`` entry point: a plain callable, or a
        ``functools.partial(<callable>, ...)`` wrapping one (the standard
        way to hand a thread entry bound arguments)."""
        if isinstance(value, ast.Call):
            name = self.resolve_name(fn, value.func)
            if name in ("functools.partial", "partial") and value.args:
                return self.resolve_callable(fn, value.args[0], local_types)
            return None
        return self.resolve_callable(fn, value, local_types)

    def _resolve_calls(self) -> None:
        for fn in list(self.functions.values()):
            callees: Set[str] = set()
            unresolved: List[ast.Call] = []
            local_types = self._local_types(fn)
            for node in own_nodes(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                target = self.resolve_callable(fn, node.func, local_types)
                if target is not None:
                    callees.add(target.qualname)
                else:
                    unresolved.append(node)
                # thread spawn site?
                name = self.resolve_name(fn, node.func)
                if name and name.rsplit(".", 1)[-1] == "Thread" and (
                    name.startswith("threading.") or name == "Thread"
                ):
                    tgt = None
                    for kw in node.keywords:
                        if kw.arg == "target":
                            tgt = self._resolve_spawn_target(
                                fn, kw.value, local_types
                            )
                    self.thread_spawns.append(
                        ThreadSpawn(function=fn, target=tgt, node=node)
                    )
                    if tgt is not None:
                        callees.add(tgt.qualname)  # runs concurrently, but
                        # reachability-wise the spawn reaches the target
                # functions passed by name into a compiler are compiled
                tail = name.rsplit(".", 1)[-1] if name else None
                if tail in _TRACING_TAILS:
                    for arg in node.args:
                        passed = self.resolve_callable(fn, arg, local_types) \
                            if isinstance(arg, (ast.Name, ast.Attribute)) \
                            else None
                        if passed is not None:
                            passed.is_traced = True
            self.edges[fn.qualname] = callees
            if unresolved:
                self.unresolved[fn.qualname] = unresolved

    # ------------------------------------------------------ overrides
    @staticmethod
    def _is_abstract(fn: FunctionInfo) -> bool:
        """A method whose body is only ``raise`` / ``pass`` / ``...`` /
        a docstring — the package's abstract-surface idiom (the
        ``ControlPlane`` backend hooks). Calls resolving to one of these
        tell the static edges nothing; the override edges carry the
        dispatch into the concrete backends."""
        body = list(getattr(fn.node, "body", []))
        if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant
        ) and isinstance(body[0].value.value, str):
            body = body[1:]
        if not body:
            return True
        for stmt in body:
            if isinstance(stmt, (ast.Raise, ast.Pass)):
                continue
            if isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Constant
            ) and stmt.value.value is Ellipsis:
                continue
            return False
        return True

    def _infer_overrides(self) -> None:
        """``override_edges``: abstract method -> same-named methods of
        every subclass in the package (single-level base resolution, the
        same best effort :meth:`_method_of` applies upward)."""
        # class dotted -> direct subclasses (dotted)
        subclasses: Dict[str, List[str]] = {}
        for cinfo in self.classes.values():
            for b in cinfo.bases:
                base = self.classes.get(b)
                if base is None and b:
                    base = self._lookup_class(cinfo.module, b.split(".")[-1])
                if base is not None:
                    subclasses.setdefault(base.dotted, []).append(
                        cinfo.dotted
                    )
        for class_dotted, subs in subclasses.items():
            cinfo = self.classes[class_dotted]
            for name, meth in cinfo.methods.items():
                if not self._is_abstract(meth):
                    continue
                stack = list(subs)
                seen: Set[str] = set()
                while stack:
                    sub = stack.pop()
                    if sub in seen:
                        continue
                    seen.add(sub)
                    sub_info = self.classes.get(sub)
                    if sub_info is None:
                        continue
                    override = sub_info.methods.get(name)
                    if override is not None and override is not meth:
                        self.override_edges.setdefault(
                            meth.qualname, set()
                        ).add(override.qualname)
                    stack.extend(subclasses.get(sub, ()))

    # ------------------------------------------------------- reachability
    def find(self, spec: str) -> List[FunctionInfo]:
        """Functions whose class-qualified dotted name ends with ``spec``
        (match at a dot boundary): ``"ServeEngine.tick"`` finds the tick
        method wherever the class lives; ``"run_training"`` finds every
        function of that name."""
        out = []
        for fn in self.functions.values():
            d = fn.dotted
            if d == spec or d.endswith("." + spec):
                out.append(fn)
        return out

    def reachable(self, roots: Iterable[FunctionInfo],
                  stops: Iterable[str] = ()) -> List[FunctionInfo]:
        """BFS over call edges from ``roots``. Functions whose simple
        name or dotted suffix matches an entry in ``stops`` are neither
        scanned nor expanded (the documented off-hot-path subtrees)."""
        stop_set = set(stops)

        def stopped(fn: FunctionInfo) -> bool:
            return fn.name in stop_set or any(
                fn.dotted == s or fn.dotted.endswith("." + s)
                for s in stop_set
            )

        seen: Set[str] = set()
        order: List[FunctionInfo] = []
        queue = [f for f in roots if not stopped(f)]
        for f in queue:
            seen.add(f.qualname)
        while queue:
            fn = queue.pop(0)
            order.append(fn)
            for callee in sorted(self.edges.get(fn.qualname, ())):
                if callee in seen:
                    continue
                target = self.functions.get(callee)
                if target is None or stopped(target):
                    continue
                seen.add(callee)
                queue.append(target)
        return order

    def descendants(self, seeds: Iterable[str],
                    virtual: bool = False) -> Set[str]:
        """Qualnames reachable from ``seeds`` (qualnames), seeds
        included. ``virtual=True`` additionally follows
        :attr:`override_edges` — a call on an abstract surface reaches
        every backend override (the protocol rules' dispatch model;
        the concurrency rules keep the exact static edges)."""
        seen: Set[str] = set()
        queue = [s for s in seeds if s in self.functions]
        seen.update(queue)
        while queue:
            q = queue.pop(0)
            callees: Set[str] = set(self.edges.get(q, ()))
            if virtual:
                callees |= self.override_edges.get(q, set())
            for callee in sorted(callees):
                if callee not in seen and callee in self.functions:
                    seen.add(callee)
                    queue.append(callee)
        return seen
