"""Whole-program concurrency & hot-path contract rules (STA009-STA011;
counterpart of ``scaling_tpu/analysis/concurrency.py``).

Three gate rules over the :mod:`callgraph` engine:

**STA009 — lock-discipline race lint.** For every class that spawns a
``threading.Thread(target=...)`` onto one of its own methods (or a
closure inside one), partition the class's code into *sides*: each
thread entry's reachable method set, plus the main-thread side (the
public API). An instance attribute MUTATED on one side and read or
written on another must share a common ``with self.<lock>:`` guard on
both paths. Deliberately lock-free fields (GIL-atomic scalar handoffs
like a watchdog's ``_last_beat``) are declared with an
``# sta: lock(<attr>, ...)`` annotation anywhere in the class body,
with a comment saying WHY.

**STA010 — device-sync-on-hot-path.** The static complement of the
port's runtime no-sync check (``torch.cuda.set_sync_debug_mode``):
walking the call graph from the trainer step dispatch (``run_training``
/ ``train_step``), the serving tick (``ServeEngine.tick``) and the
fleet router dispatch (``FleetRouter.submit``), flag every device-sync
primitive — ``torch.cuda.synchronize`` by name, ``.synchronize()`` on
an event or a stream, ``.item()`` and ``.cpu()`` on anything,
``.to("cpu")``, and ``.tolist()`` / ``.numpy()`` / ``float()`` /
``int()`` / ``bool()`` / ``np.asarray()`` applied to a value the
intra-function taint analysis traces back to a device computation (a
``torch.*`` tensor op, or a call into a function whose return is
device-tainted — including unresolvable callables fed device operands).
Shape metadata (``x.shape``, ``x.size(0)``, ``x.numel()``, ...) is host
data and never taints. The documented sync windows (checkpoint save,
eval, preemption exit, stall forensics) are pruned via
``HOT_PATH_STOPS``; the remaining deliberate syncs (the log-interval
fetch, the tick's token landing) carry per-line suppressions with
justifying comments. Compiled functions (``torch.compile``, Triton's
``jit``) are skipped.

**STA011 — unguarded-I/O audit.** Raw ``open`` / ``os.replace`` /
``os.rename`` / ``os.write`` / ``socket.*`` / ``Path.read_text``-family
calls inside the gated subsystems (``resilience/``, ``serve/``,
``runner/``, ``obs/``, ``checkpoint/``) must be *reachable under* a
guard — a function that fires a :class:`FaultPlan` point, or a callable
passed into ``retry_io`` (closures and lambdas included); everything
such a function transitively calls inherits the guard. Anything else is
a new I/O path dodging the contract — wire it through ``retry_io``/a
fault point, or suppress with a comment explaining why the path must
stay raw (e.g. obs cannot import resilience without inverting the
layering).

All three ride the standard lint plumbing: per-line
``# sta: disable=STA0xx`` suppression, findings in the same JSON
schema, clean tree pinned at zero unsuppressed findings.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .callgraph import CallGraph, ClassInfo, FunctionInfo, own_nodes

# ---------------------------------------------------------------- config

# Hot-path roots (STA010), matched as dotted-name suffixes against the
# analyzed tree: the trainer's step dispatch, the serving engine's tick,
# and the fleet router's dispatch path.
HOT_PATH_ROOTS = (
    "run_training",
    "train_step",
    "ServeEngine.tick",
    "ServeEngine.run_until_done",
    "FleetRouter.submit",
)

# Subtrees pruned from the hot path: these are the DOCUMENTED sync
# windows (checkpointing and eval drain the device by design, the
# preemption/stall paths run off the steady-state loop). A sync inside
# them is policy, not a regression.
HOT_PATH_STOPS = (
    "save_checkpoint",
    "_save_checkpoint_inner",
    "load_checkpoint",
    "_load_step_dir",
    "eval_step",
    "_eval_step_inner",
    "_preemption_exit",
    "_on_step_stall",
    "_run_checkpoint_hooks",
    "finalize_checkpoints",
    "stop_prefetch",
)

# Device-sync primitives flagged by NAME wherever they appear on the hot
# path (the calls the runtime no-sync check turns into errors)
SYNC_PRIMITIVES = {
    "torch.cuda.synchronize",
}
# methods that sync whatever they are called on: an event's or a stream's
# ``synchronize``, a tensor's ``item`` and ``cpu``
_SYNC_METHODS = {"synchronize", "item", "cpu"}
# methods that sync when called on a device value
_SYNC_METHODS_TAINTED = {"tolist", "numpy"}
# methods whose result is host data (the pull is flagged at its own call)
_HOST_RESULT_METHODS = {"item", "cpu", "tolist", "numpy"}

# ``torch.*`` callables whose results are host data, not tensors
_TORCH_HOST_CALLS = {
    "torch.device", "torch.dtype", "torch.is_tensor", "torch.finfo",
    "torch.iinfo", "torch.Size", "torch.get_default_dtype", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.is_grad_enabled",
    "torch.get_num_threads", "torch.set_num_threads", "torch.manual_seed",
    "torch.Generator", "torch.is_floating_point",
}
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                        "torch.utils.", "torch.profiler.", "torch.autograd.",
                        "torch.nn.")

# tensor metadata: host values by construction, never device data
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "requires_grad",
                 "layout", "size", "numel", "dim", "stride", "data_ptr",
                 "element_size", "is_contiguous", "nbytes", "itemsize"}


def _is_device_call(name: str) -> bool:
    """A resolved ``torch.*`` callable that returns a tensor."""
    if name.split(".")[0] != "torch" or name in _TORCH_HOST_CALLS:
        return False
    return not name.startswith(_TORCH_HOST_PREFIXES)


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``: a device->host copy."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    vals = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu" for v in vals)


# host conversions flagged when fed a device-tainted value
_HOST_CONVERSIONS = {"float", "int", "bool"}
_HOST_PULLS = {"numpy.asarray", "numpy.array"}

# Directory scope of the unguarded-I/O audit (STA011): the subsystems
# whose I/O the resilience gate owns.
IO_SCOPE_DIRS = ("resilience", "serve", "runner", "obs", "checkpoint")

# raw I/O callables by resolved dotted name
_RAW_IO_NAMES = {
    "open", "os.open", "os.replace", "os.rename", "os.write",
    "socket.socket", "socket.create_connection",
}
# raw I/O method calls by attribute name (Path-object file I/O)
_RAW_IO_ATTRS = {"write_text", "write_bytes", "read_text", "read_bytes"}

# Process-lifecycle fault points: they model step/process faults (a
# kill at the loop top, an injected NaN), NOT I/O coverage — a function
# firing one does not make the checkpoint/journal writes it transitively
# reaches "guarded" (the whole save tree hangs off the train loop).
PROCESS_FAULT_POINTS = {
    "signal.sigterm", "host.kill", "host.hang", "step.nan_grads",
    # the serve worker's mid-tick SIGKILL drill: fired at the replica
    # tick-loop top, same class of point as host.kill — the engine tick
    # tree hanging off it is compute, not I/O
    "serve.replica.kill",
}

# lock-free-field annotation: ``# sta: lock(attr_a, attr_b)`` in a class
# body declares those instance attributes' lock-free sharing deliberate
_LOCKFREE_RE = re.compile(r"#\s*sta:\s*lock\(([^)]*)\)")


def _annotation_comments(mod, node) -> List[Tuple[int, str]]:
    """Real COMMENT tokens within a node's lexical range (docstrings
    quoting an annotation never count — see lint.iter_comments)."""
    from .lint import iter_comments

    end = getattr(node, "end_lineno", node.lineno)
    return [(i, t) for i, t in iter_comments(mod.source)
            if node.lineno <= i <= end]

# attribute types that are themselves synchronization/thread-safe
_SAFE_ATTR_CONSTRUCTORS = (
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Event", "threading.Semaphore", "threading.BoundedSemaphore",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "collections.deque",
)
_LOCK_CONSTRUCTORS = ("threading.Lock", "threading.RLock",
                      "threading.Condition")

# collection mutators: calling one of these ON an attribute mutates it
_MUTATING_METHODS = {
    "append", "appendleft", "add", "remove", "discard", "pop", "popleft",
    "popitem", "clear", "extend", "extendleft", "insert", "update",
    "setdefault", "sort", "reverse", "rotate",
}


# ---------------------------------------------------------------- shared
class _Emitter:
    """Finding construction + per-line suppression, shared by the three
    rules (same contract as the per-file lint)."""

    def __init__(self) -> None:
        from .lint import Finding, RULES  # lazy: lint imports us lazily too

        self._Finding = Finding
        self._rules = RULES
        self.findings: List = []
        self._suppressions: Dict[str, Dict[int, Optional[Set[str]]]] = {}

    def _file_suppressions(self, mod) -> Dict[int, Optional[Set[str]]]:
        if mod.rel not in self._suppressions:
            from .lint import parse_suppressions

            self._suppressions[mod.rel] = parse_suppressions(mod.source)
        return self._suppressions[mod.rel]

    def emit(self, rule: str, mod, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        rules_at = self._file_suppressions(mod).get(line, "absent")
        suppressed = rules_at is None or (
            isinstance(rules_at, set) and rule in rules_at
        )
        self.findings.append(self._Finding(
            rule, self._rules[rule][0], mod.rel, line,
            getattr(node, "col_offset", 0), message, suppressed,
        ))


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.<attr>`` -> attr name (one level only)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


# ================================================================ STA009
class _ClassConcurrency:
    """Per-class lock/thread model: lock attrs, safe attrs, lock-free
    annotations, and the attribute-access inventory per side."""

    def __init__(self, graph: CallGraph, cinfo: ClassInfo):
        self.graph = graph
        self.cinfo = cinfo
        self.lock_attrs: Set[str] = set()
        self.safe_attrs: Set[str] = set()
        self.lockfree: Set[str] = set()
        self._scan_attr_kinds()
        self._scan_annotations()

    def _scan_attr_kinds(self) -> None:
        mod = self.cinfo.module
        for meth in self.cinfo.methods.values():
            for node in ast.walk(meth.node):
                if not isinstance(node, ast.Assign):
                    continue
                if not isinstance(node.value, ast.Call):
                    continue
                name = mod.imports.resolve(node.value.func)
                if name is None:
                    continue
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    if name in _LOCK_CONSTRUCTORS:
                        self.lock_attrs.add(attr)
                        self.safe_attrs.add(attr)
                    elif name in _SAFE_ATTR_CONSTRUCTORS:
                        self.safe_attrs.add(attr)

    def _scan_annotations(self) -> None:
        for _, text in _annotation_comments(self.cinfo.module,
                                            self.cinfo.node):
            m = _LOCKFREE_RE.search(text)
            if m:
                self.lockfree.update(
                    a.strip() for a in m.group(1).split(",") if a.strip()
                )

    # ---------------------------------------------------------- accesses
    def class_functions(self) -> Set[str]:
        """Qualnames of this class's methods and their nested closures
        (both see ``self``)."""
        out: Set[str] = set()
        for fn in self.graph.functions.values():
            if fn.module is not self.cinfo.module:
                continue
            top = fn.dotted.split(".")[0]
            if top == self.cinfo.name:
                out.add(fn.qualname)
        return out

    def side_functions(self, entry: FunctionInfo,
                       stops: Iterable[str] = ()) -> Set[str]:
        """The subset of this class's functions reachable from ``entry``
        (the thread's — or the public API's — footprint inside the
        class). ``stops`` cuts traversal at the named functions: the
        main-thread side passes the thread entries' dotted names so a
        helper reachable ONLY through a spawn target stays on the
        thread's side (a shared helper, also called from a main-side
        path, still lands on both)."""
        in_class = self.class_functions()
        reach = self.graph.reachable([entry], stops=stops)
        return {f.qualname for f in reach if f.qualname in in_class}

    def accesses(self, funcs: Set[str], skip_init: bool = True
                 ) -> Dict[str, List[Tuple[str, FunctionInfo, ast.AST,
                                           frozenset]]]:
        """attr -> [(kind, function, node, locks_held)] over ``funcs``.
        ``kind`` is 'read' or 'write'. ``locks_held`` is the set of this
        class's lock attributes lexically held (``with self.<lock>:``)
        at the access, plus locks held at every call site on all paths
        into the function from the side's entry (computed by the
        caller via :meth:`entry_locks`)."""
        out: Dict[str, List[Tuple[str, FunctionInfo, ast.AST, frozenset]]] = {}
        for qual in sorted(funcs):
            fn = self.graph.functions[qual]
            if skip_init and fn.dotted.endswith("__init__"):
                continue
            for attr, kind, node, locks in self._scan_function(fn):
                out.setdefault(attr, []).append((kind, fn, node, locks))
        return out

    def _scan_function(self, fn: FunctionInfo):
        """Yield (attr, kind, node, lexical_locks) for every self-attr
        access in ``fn``, tracking the ``with self.<lock>:`` stack."""
        results: List[Tuple[str, str, ast.AST, frozenset]] = []

        def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return  # closures scanned as their own functions
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = list(held)
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr in self.lock_attrs:
                        acquired.append(attr)
                for item in node.items:
                    walk(item.context_expr, held)
                for child in node.body:
                    walk(child, tuple(acquired))
                return
            attr = _self_attr(node)
            if attr is not None:
                if isinstance(node.ctx, (ast.Store, ast.Del)):
                    results.append((attr, "write", node, frozenset(held)))
                else:
                    results.append((attr, "read", node, frozenset(held)))
            # self.attr[i] = v / self.attr += v mutate the attr
            if isinstance(node, ast.Subscript):
                a = _self_attr(node.value)
                if a is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
                    results.append((a, "write", node, frozenset(held)))
            if isinstance(node, ast.AugAssign):
                a = _self_attr(node.target)
                if a is not None:
                    results.append((a, "write", node.target, frozenset(held)))
                sub = node.target
                if isinstance(sub, ast.Subscript):
                    a = _self_attr(sub.value)
                    if a is not None:
                        results.append((a, "write", sub, frozenset(held)))
            # mutating method call: self.attr.append(...)
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in _MUTATING_METHODS:
                a = _self_attr(node.func.value)
                if a is not None:
                    results.append((a, "write", node, frozenset(held)))
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for child in ast.iter_child_nodes(fn.node):
            walk(child, ())
        return results

    def entry_locks(self, entry: FunctionInfo, side: Set[str]
                    ) -> Dict[str, frozenset]:
        """For each function of the side, the set of locks held on EVERY
        call path from ``entry`` (meet-over-paths: intersection). A
        method only ever invoked inside ``with self._lock:`` inherits
        the guard."""
        # call sites are invariant across fixed-point iterations — scan
        # each side function's AST once, not once per iteration
        sites = {qual: self._call_sites(self.graph.functions[qual])
                 for qual in side}
        state: Dict[str, Optional[frozenset]] = {entry.qualname: frozenset()}
        changed = True
        while changed:
            changed = False
            for qual in sorted(side):
                locks = state.get(qual)
                if locks is None:
                    continue
                for callee, call_locks in sites[qual]:
                    if callee not in side:
                        continue
                    merged = locks | call_locks
                    prev = state.get(callee)
                    new = merged if prev is None else (prev & merged)
                    if new != prev:
                        state[callee] = new
                        changed = True
        return {q: (s or frozenset()) for q, s in state.items()
                if s is not None}

    def _call_sites(self, fn: FunctionInfo
                    ) -> List[Tuple[str, frozenset]]:
        """(callee qualname, lexical locks at the call) pairs inside
        ``fn``."""
        sites: List[Tuple[str, frozenset]] = []
        local_types = self.graph._local_types(fn)

        def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = list(held)
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr in self.lock_attrs:
                        acquired.append(attr)
                for child in node.body:
                    walk(child, tuple(acquired))
                return
            if isinstance(node, ast.Call):
                target = self.graph.resolve_callable(
                    self.graph.functions[fn.qualname], node.func, local_types
                )
                if target is not None:
                    sites.append((target.qualname, frozenset(held)))
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for child in ast.iter_child_nodes(fn.node):
            walk(child, ())
        return sites


def check_lock_discipline(
    graph: CallGraph,
    lock_usage: Optional[Set[Tuple[str, str]]] = None,
) -> List:
    """STA009 over every class that spawns threads onto its own code.

    ``lock_usage`` (when given) collects ``(class_dotted, attr)`` pairs
    whose ``# sta: lock(attr)`` annotation suppressed a real hazard —
    the stale-suppression audit's ground truth."""
    em = _Emitter()
    # class dotted -> [(side label, entry FunctionInfo)]
    per_class: Dict[str, List[Tuple[str, FunctionInfo]]] = {}
    for spawn in graph.thread_spawns:
        tgt = spawn.target
        if tgt is None:
            continue
        # the thread target must belong to a class of the same module:
        # a method, or a closure nested inside one
        owner = tgt.dotted.split(".")[0]
        cinfo = tgt.module.classes.get(owner)
        if cinfo is None:
            continue
        per_class.setdefault(cinfo.dotted, [])
        label = f"thread '{tgt.name}'"
        if (label, tgt) not in per_class[cinfo.dotted]:
            per_class[cinfo.dotted].append((label, tgt))

    for class_dotted in sorted(per_class):
        cinfo = graph.classes[class_dotted]
        model = _ClassConcurrency(graph, cinfo)
        entries = per_class[class_dotted]
        thread_entry_names = {e.qualname for _, e in entries}

        sides: List[Tuple[str, Dict[str, List]]] = []
        for label, entry in entries:
            side = model.side_functions(entry)
            locks = model.entry_locks(entry, side)
            acc = model.accesses(side)
            sides.append((label, _with_entry_locks(acc, locks)))

        # the main-thread side: the public API and everything it reaches
        # WITHOUT traversing into a spawn target — a helper reachable
        # only through the thread entry belongs to the thread's side,
        # not the main side (else a thread-exclusive field reads as a
        # race of the worker against itself)
        thread_stops = [e.dotted for _, e in entries]
        main_entries = [
            m for name, m in sorted(cinfo.methods.items())
            if not name.startswith("_") and m.qualname
            not in thread_entry_names
        ]
        main_acc_merged: Dict[str, List] = {}
        for m in main_entries:
            side = model.side_functions(m, stops=thread_stops)
            side -= thread_entry_names  # spawn target runs on ITS thread
            locks = model.entry_locks(m, side)
            for attr, lst in _with_entry_locks(
                model.accesses(side), locks
            ).items():
                main_acc_merged.setdefault(attr, []).extend(lst)
        if main_acc_merged:
            sides.append(("the main-thread public API", main_acc_merged))

        _report_races(em, cinfo, model, sides, lock_usage)
    return em.findings


def _with_entry_locks(acc: Dict[str, List], locks: Dict[str, frozenset]
                      ) -> Dict[str, List]:
    out: Dict[str, List] = {}
    for attr, lst in acc.items():
        out[attr] = [
            (kind, fn, node, held | locks.get(fn.qualname, frozenset()))
            for kind, fn, node, held in lst
        ]
    return out


def _report_races(em: _Emitter, cinfo: ClassInfo, model: _ClassConcurrency,
                  sides: List[Tuple[str, Dict[str, List]]],
                  lock_usage: Optional[Set[Tuple[str, str]]] = None) -> None:
    attrs: Set[str] = set()
    for _, acc in sides:
        attrs |= set(acc)
    for attr in sorted(attrs):
        if attr in model.safe_attrs:
            continue
        # collect (side, access) pairs; hazard = a WRITE on one side and
        # any access on another with no common lock between them
        hazard = None
        hazard_key = None
        for i, (label_w, acc_w) in enumerate(sides):
            for kind, fn_w, node_w, locks_w in acc_w.get(attr, ()):
                if kind != "write":
                    continue
                for j, (label_o, acc_o) in enumerate(sides):
                    if i == j:
                        continue
                    for okind, fn_o, node_o, locks_o in acc_o.get(attr, ()):
                        if locks_w & locks_o:
                            continue
                        key = (node_w.lineno, node_o.lineno, label_w,
                               label_o)
                        if hazard_key is None or key < hazard_key:
                            hazard_key = key
                            hazard = (label_w, fn_w, node_w,
                                      label_o, fn_o, node_o, okind)
        if hazard is None:
            continue
        # the lockfree check sits AFTER hazard detection so the stale-
        # suppression audit (STA015) can tell a load-bearing
        # `# sta: lock(attr)` from one whose hazard no longer exists
        if attr in model.lockfree:
            if lock_usage is not None:
                lock_usage.add((cinfo.dotted, attr))
            continue
        label_w, fn_w, node_w, label_o, fn_o, node_o, okind = hazard
        em.emit(
            "STA009", cinfo.module, node_w,
            f"{cinfo.name}.{attr} is written on {label_w} "
            f"({fn_w.name}, line {node_w.lineno}) and "
            f"{'written' if okind == 'write' else 'read'} on {label_o} "
            f"({fn_o.name}, line {node_o.lineno}) with no common "
            f"'with self.<lock>:' guard — a cross-thread race. Guard "
            f"both paths with one lock, or declare the field "
            f"deliberately lock-free with '# sta: lock({attr})' and a "
            f"comment saying why (e.g. GIL-atomic scalar handoff)",
        )


# ================================================================ STA010
class _TaintScan:
    """Intra-function device-value taint with cross-function return
    propagation: which names carry (possibly) device-resident tensors."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.returns_device: Dict[str, bool] = {}

    def _call_is_device(self, fn: FunctionInfo, node: ast.Call,
                        tainted: Set[str], local_types) -> bool:
        name = self.graph.resolve_name(fn, node.func)
        if name:
            if name in _HOST_PULLS:
                return False  # np.asarray lands on host (the sync itself
                # is flagged at the call site, its result is host data)
            if _is_device_call(name):
                return True
        target = self.graph.resolve_callable(fn, node.func, local_types)
        if target is not None:
            return self.returns_device.get(target.qualname, False)
        # unresolvable callable (jitted program handle, dict dispatch):
        # device operands in -> assume device results out
        return any(
            self._expr_tainted(fn, a, tainted, local_types)
            for a in list(node.args) + [kw.value for kw in node.keywords]
        )

    def _expr_tainted(self, fn: FunctionInfo, node: ast.AST,
                      tainted: Set[str], local_types) -> bool:
        """Does the expression carry a device value? Host pulls
        (``np.asarray(x)``) land on host: the walk does not descend into
        them — their RESULT is host data (the pull itself is flagged at
        its own call site, once)."""
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
                continue  # x.shape, x.size(0): host metadata
            if isinstance(n, ast.Name) and n.id in tainted:
                return True
            if isinstance(n, ast.Call):
                name = self.graph.resolve_name(fn, n.func)
                if name in _HOST_PULLS or _to_cpu(n) or (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr in _HOST_RESULT_METHODS
                ):
                    continue  # result is host data; don't descend
                if self._call_is_device(fn, n, tainted, local_types):
                    return True
            stack.extend(ast.iter_child_nodes(n))
        return False

    @staticmethod
    def _name_targets(tgt: ast.AST) -> List[str]:
        """Plain names BOUND by an assignment target. Attribute and
        subscript stores (``self.x[i] = v``) mutate objects — they do
        not make the base name a device value."""
        if isinstance(tgt, ast.Name):
            return [tgt.id]
        if isinstance(tgt, (ast.Tuple, ast.List)):
            out: List[str] = []
            for el in tgt.elts:
                out.extend(_TaintScan._name_targets(el))
            return out
        if isinstance(tgt, ast.Starred):
            return _TaintScan._name_targets(tgt.value)
        return []

    def function_taint(self, fn: FunctionInfo) -> Set[str]:
        """Names in ``fn`` carrying device values (fixed point over the
        function's assignments)."""
        local_types = self.graph._local_types(fn)
        tainted: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for node in own_nodes(fn.node):
                targets: List[ast.AST] = []
                value = None
                if isinstance(node, ast.Assign):
                    targets, value = list(node.targets), node.value
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                        and node.value is not None:
                    targets, value = [node.target], node.value
                if value is None:
                    continue
                if self._expr_tainted(fn, value, tainted, local_types):
                    for tgt in targets:
                        for name in self._name_targets(tgt):
                            if name not in tainted:
                                tainted.add(name)
                                changed = True
        return tainted

    def compute_return_taint(self, funcs: Iterable[FunctionInfo]) -> None:
        """Fixed point of "returns a device value" over ``funcs``."""
        funcs = list(funcs)
        for _ in range(3):  # call chains deeper than 3 are rare; bounded
            changed = False
            for fn in funcs:
                tainted = self.function_taint(fn)
                local_types = self.graph._local_types(fn)
                ret = False
                for node in own_nodes(fn.node):
                    if isinstance(node, ast.Return) and node.value is not None:
                        if self._expr_tainted(fn, node.value, tainted,
                                              local_types):
                            ret = True
                            break
                if ret != self.returns_device.get(fn.qualname, False):
                    self.returns_device[fn.qualname] = ret
                    changed = True
            if not changed:
                break


def check_hot_path_syncs(
    graph: CallGraph,
    roots: Iterable[str] = HOT_PATH_ROOTS,
    stops: Iterable[str] = HOT_PATH_STOPS,
) -> List:
    """STA010: device syncs reachable from the step/tick/dispatch roots."""
    em = _Emitter()
    root_fns: List[FunctionInfo] = []
    for spec in roots:
        root_fns.extend(graph.find(spec))
    if not root_fns:
        return []
    reach = [f for f in graph.reachable(root_fns, stops=stops)
             if not f.is_traced]
    taint = _TaintScan(graph)
    taint.compute_return_taint(reach)
    for fn in reach:
        tainted = taint.function_taint(fn)
        local_types = graph._local_types(fn)
        for node in own_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            name = graph.resolve_name(fn, node.func)
            if name in SYNC_PRIMITIVES:
                em.emit(
                    "STA010", fn.module, node,
                    f"{name} on the hot path (reachable from "
                    f"{_root_label(graph, root_fns, fn)}): drains device "
                    "work per step/tick — keep telemetry and bookkeeping "
                    "host-side",
                )
                continue
            if isinstance(node.func, ast.Attribute) and not node.args and (
                node.func.attr in _SYNC_METHODS
                or (node.func.attr in _SYNC_METHODS_TAINTED
                    and taint._expr_tainted(fn, node.func.value, tainted,
                                            local_types))
            ):
                em.emit(
                    "STA010", fn.module, node,
                    f".{node.func.attr}() on the hot path is a device->host "
                    "sync (reachable from "
                    f"{_root_label(graph, root_fns, fn)})",
                )
                continue
            if _to_cpu(node):
                em.emit(
                    "STA010", fn.module, node,
                    ".to('cpu') on the hot path is a device->host copy "
                    "(reachable from "
                    f"{_root_label(graph, root_fns, fn)})",
                )
                continue
            if name in _HOST_CONVERSIONS and node.args and \
                    taint._expr_tainted(fn, node.args[0], tainted,
                                        local_types):
                em.emit(
                    "STA010", fn.module, node,
                    f"{name}() on a device value blocks on a device->host "
                    "transfer on the hot path (reachable from "
                    f"{_root_label(graph, root_fns, fn)})",
                )
                continue
            if name in _HOST_PULLS and node.args and \
                    taint._expr_tainted(fn, node.args[0], tainted,
                                        local_types):
                em.emit(
                    "STA010", fn.module, node,
                    f"{name.replace('numpy', 'np')}() on a device value "
                    "pulls it to host on the hot path (reachable from "
                    f"{_root_label(graph, root_fns, fn)})",
                )
    return em.findings


def _root_label(graph: CallGraph, roots: List[FunctionInfo],
                fn: FunctionInfo) -> str:
    for r in roots:
        if fn.qualname == r.qualname:
            return r.dotted
        if fn.qualname in graph.descendants([r.qualname]):
            return r.dotted
    return roots[0].dotted


# ================================================================ STA011
def _in_scope(rel: str, scope_dirs: Iterable[str]) -> bool:
    norm = rel.replace("\\", "/")
    return any(f"/{d}/" in f"/{norm}" for d in scope_dirs)


def _guard_seeds(graph: CallGraph) -> Tuple[Set[str], Dict[str, Set[int]]]:
    """Functions that establish an I/O guard context, plus per-function
    line ranges guarded lexically (lambda bodies passed to retry_io).

    A seed is a function that (a) fires a FaultPlan point
    (``<plan>.fire("point")``) or (b) is passed into ``retry_io`` as
    the retried callable (by name — module functions, methods, nested
    closures). Everything a seed transitively calls runs under the
    guard."""
    seeds: Set[str] = set()
    regions: Dict[str, Set[int]] = {}
    for fn in graph.functions.values():
        local_types = graph._local_types(fn)
        for node in own_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            # (a) fault-point fire: <anything>.fire("point"[, ...]) —
            # process-lifecycle points excluded (firing host.kill at the
            # loop top is not I/O coverage for the save tree below it)
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "fire"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and node.args[0].value not in PROCESS_FAULT_POINTS
            ):
                seeds.add(fn.qualname)
                continue
            # (b) retry_io(callable, ...)
            name = graph.resolve_name(fn, node.func)
            if not (name and name.rsplit(".", 1)[-1] == "retry_io"):
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Lambda):
                # the lambda body is guarded lexically; functions it
                # calls are guarded transitively
                regions.setdefault(fn.qualname, set()).update(
                    range(arg.lineno, getattr(arg, "end_lineno",
                                              arg.lineno) + 1)
                )
                for sub in ast.walk(arg.body):
                    if isinstance(sub, ast.Call):
                        t = graph.resolve_callable(fn, sub.func, local_types)
                        if t is not None:
                            seeds.add(t.qualname)
            else:
                t = graph.resolve_callable(fn, arg, local_types)
                if t is not None:
                    seeds.add(t.qualname)
    return seeds, regions


def check_unguarded_io(
    graph: CallGraph, scope_dirs: Iterable[str] = IO_SCOPE_DIRS
) -> List:
    """STA011: raw I/O in the gated subsystems outside every
    retry/fault guard context."""
    em = _Emitter()
    seeds, regions = _guard_seeds(graph)
    guarded = graph.descendants(seeds)
    for qual in sorted(graph.functions):
        fn = graph.functions[qual]
        if not _in_scope(fn.module.rel, scope_dirs):
            continue
        if qual in guarded:
            continue
        guarded_lines = regions.get(qual, set())
        for node in own_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            if getattr(node, "lineno", 0) in guarded_lines:
                continue
            name = graph.resolve_name(fn, node.func)
            is_raw = name in _RAW_IO_NAMES
            if not is_raw and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _RAW_IO_ATTRS:
                is_raw = True
                name = node.func.attr
            if not is_raw:
                continue
            em.emit(
                "STA011", fn.module, node,
                f"raw {name}() in {fn.dotted} is not reachable under "
                "retry_io or a FaultPlan point — the resilience gate's "
                "contract is that new I/O paths in "
                f"{'/'.join(scope_dirs)} take a fault point + bounded "
                "retry (docs/RESILIENCE.md); wire it through, or "
                "suppress with a comment explaining why this path must "
                "stay raw",
            )
    return em.findings


# ---------------------------------------------------------------- entry point
class _Loc:
    """Pseudo-node carrying a location for comment-anchored findings."""

    def __init__(self, lineno: int, col_offset: int = 0) -> None:
        self.lineno = lineno
        self.col_offset = col_offset


def check_stale_lock_annotations(
    graph: CallGraph,
    lock_usage: Set[Tuple[str, str]],
    em: Optional[_Emitter] = None,
) -> List:
    """STA015 (lock half): a ``# sta: lock(attr, ...)`` annotation is
    stale when NONE of its attrs suppressed a hazard this run — either
    the class no longer spawns threads onto its own code, or the
    racing access pattern is gone. Stale annotations are worse than
    noise: they pre-suppress the next real race on that field."""
    em = em or _Emitter()
    for class_dotted in sorted(graph.classes):
        cinfo = graph.classes[class_dotted]
        for lineno, text in _annotation_comments(cinfo.module, cinfo.node):
            m = _LOCKFREE_RE.search(text)
            if not m:
                continue
            attrs = [a.strip() for a in m.group(1).split(",") if a.strip()]
            if any((class_dotted, a) in lock_usage for a in attrs):
                continue
            em.emit(
                "STA015", cinfo.module, _Loc(lineno),
                f"stale '# sta: lock({m.group(1).strip()})' on "
                f"{cinfo.name}: no cross-thread hazard on "
                f"{'these fields' if len(attrs) > 1 else 'this field'} "
                "is being suppressed — the class no longer races here. "
                "Remove the annotation (keep the prose if it documents "
                "intent) so it cannot pre-suppress the next real race",
            )
    return em.findings


def check_program(paths: Iterable[Path | str],
                  root: Optional[Path | str] = None,
                  graph: Optional[CallGraph] = None) -> List:
    """Every whole-program rule (STA009-STA015) over ONE shared call
    graph — pass ``graph`` to reuse a prebuilt one (the CLI builds a
    single graph per run and shares it across commands)."""
    if graph is None:
        graph = CallGraph.build(paths, root=root)
    findings: List = []
    lock_usage: Set[Tuple[str, str]] = set()
    findings.extend(check_lock_discipline(graph, lock_usage=lock_usage))
    findings.extend(check_hot_path_syncs(graph))
    findings.extend(check_unguarded_io(graph))
    from .protocol import check_protocol  # lazy: protocol imports us

    findings.extend(check_protocol(graph))
    findings.extend(check_stale_lock_annotations(graph, lock_usage))
    return findings
