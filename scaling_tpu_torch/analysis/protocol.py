"""Distributed-protocol static analysis (STA012-STA014, STA016;
counterpart of ``scaling_tpu/analysis/protocol.py``).

The multi-host rung moves the process fleet's RPC contract and the
control-plane barriers across machine boundaries — exactly where this
repo's most expensive recurring bug class lives (barrier split-exit
deadlocks: one host entered a ``commit:step-N`` barrier on a path a
peer exited early from). These
rules catch that class in the analyzer, where a finding costs seconds
instead of a wedged pod:

**STA012 — barrier-divergence.** For every named-barrier call site
(``cp.barrier("name"/f"name-{step}", timeout)``), enumerate the
owning function's exit paths (return / raise / ``sys.exit`` /
fall-through) and flag paths that skip the barrier AFTER performing a
shared side-effect another path rendezvouses on: one host takes the
barrier path, a peer takes the early exit, and the barrier never
fills. Sanctioned exits are modeled, not suppressed wholesale —

- a ``raise`` exit is loud (the supervisor's staleness/abort machinery
  owns crashed hosts);
- a path that registers arrival (``cp.arrive(name)``, directly or via
  a resolved helper like the trainer's ``_broadcast_preempt``) parks
  no peers;
- a branch whose condition checks the abort flag (``get_flag(ABORT_*)``
  or any abort-named flag/variable) is the sanctioned drain;
- ``# sta: barrier-exempt(<name>)`` anywhere in the function body
  exempts that barrier name (with a comment saying why).

A path only fires when the exit diverges from a rendezvous path AFTER
a shared side-effect (a fault-point fire, a retry/raw I/O, a
control-plane mutation) in their common prefix: a pure guard at the
top of the function (``if cp is None: return``) diverges before any
shared work and is clean. Barrier names are matched as *templates* —
``f"commit:step-{step}"`` becomes ``commit:step-{}``.

**STA013 — RPC-contract.** Per module, extract the client op set
(dict literals with an ``"op"`` key passed into a request call — the
``ReplicaProcClient``/``TcpControlPlane`` send idiom) and the server
dispatch table (functions branching an op variable over string
constants — ``_ReplicaWorker.handle``/``TcpControlPlaneServer._handle``),
then flag: a client op with no handler, a dead handler no client ever
sends, and a reply key a client reads that no handler path for that op
returns (``ok``/``error`` are the transport envelope, always allowed).

**STA014 — protocol-edge coverage.** The STA011 contract extended to
the protocol layer: every RPC send site, named-barrier wait, and
replica spawn/kill site in the gated subsystems must sit under a
``FaultPlan`` point or ``retry_io`` guard AND inside (or beneath) an
``obs.span``. "Under" is transitive both ways: the site's enclosing
function may run beneath a guard/span, or the call's resolved target
may establish one (``ProcReplicaHandle._rpc`` -> ``retry_io``;
``ControlPlane.barrier`` opens ``barrier.wait``). Unlike STA011,
process-lifecycle fault points count here: a kill drill IS the fault
coverage for a kill site.

All three ride the standard plumbing: per-line ``# sta: disable=``
suppression, findings in the same JSON schema, clean tree pinned at
zero unsuppressed findings by the CLI gate. Resolution uses the call
graph's *virtual* dispatch (``override_edges``): a call on the
abstract ``ControlPlane`` surface reaches both backends.

The module also builds the goldens-pinned ``protocol`` inventory
(barrier name templates + participating functions, per-module RPC op
tables) — ``python -m scaling_tpu_torch.analysis protocol`` compares it to
``analysis/goldens/protocol.json`` so contract drift fails CI
structurally; ``--repin`` rewrites the golden (commit deliberately).

No torch import; pure stdlib ``ast`` over :mod:`callgraph`.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .callgraph import CallGraph, FunctionInfo, own_nodes
from .concurrency import (
    IO_SCOPE_DIRS,
    _RAW_IO_ATTRS,
    _RAW_IO_NAMES,
    _Emitter,
    _guard_seeds,
    _in_scope,
)

# STA014's scope: the I/O-gated subsystems plus the trainer (whose
# control-plane check-in owns the step/commit barriers).
PROTOCOL_SCOPE_DIRS = IO_SCOPE_DIRS + ("trainer",)

# the fault injector itself executes kills/exits — requiring the
# injector to run under a fault point is circular
_EXCLUDED_MODULE_TAILS = ("resilience.faults",)

# reply-envelope keys every handler returns implicitly
_ENVELOPE_KEYS = {"ok", "error"}

# an op-dict handed to a collection mutator is data construction (cost
# tables, record lists), not a request crossing a process boundary
_COLLECTION_MUTATORS = {
    "append", "extend", "add", "insert", "update", "setdefault",
    "put", "put_nowait", "appendleft",
}

# control-plane mutations that count as shared side-effects (STA012)
_CP_EFFECT_ATTRS = {"set_flag", "heartbeat", "prune_barrier"}

# bounded path enumeration: beyond this the function is skipped for
# STA012 (under-approximate, never explode)
MAX_PATHS = 256

_BARRIER_EXEMPT_RE = re.compile(r"#\s*sta:\s*barrier-exempt\(([^)]*)\)")


def _name_template(node: ast.AST) -> Optional[str]:
    """A constant or f-string barrier name as a template:
    ``f"commit:step-{step}"`` -> ``commit:step-{}``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("{}")
        return "".join(parts)
    return None


# ------------------------------------------------------------ model
@dataclasses.dataclass
class BarrierSite:
    fn: FunctionInfo
    node: ast.Call
    name: str  # template
    kind: str  # 'wait' | 'arrive'


@dataclasses.dataclass
class RpcSend:
    fn: FunctionInfo
    node: ast.Call
    op: Optional[str]  # None = dynamic op value
    reads: List[Tuple[str, ast.AST]] = dataclasses.field(default_factory=list)
    # the request dict carries a literal "trace" key (STA016: the
    # serving fleet's trace-propagation contract); dict_node is the
    # envelope literal itself, so the finding anchors on the dict's
    # line (where the missing key belongs), not the call's
    has_trace: bool = False
    dict_node: Optional[ast.AST] = None


@dataclasses.dataclass
class RpcHandler:
    fn: FunctionInfo
    node: ast.AST  # the `if op == "x":` statement
    op: str
    reply_keys: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ProcSite:
    fn: FunctionInfo
    node: ast.Call
    kind: str  # 'spawn' | 'kill'


class ProtocolModel:
    """The package's protocol surface plus the reachability closures
    the three rules (and the golden inventory) share."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.barrier_sites: List[BarrierSite] = []
        self.rpc_sends: Dict[str, List[RpcSend]] = {}  # modname -> sends
        self.rpc_handlers: Dict[str, Dict[str, List[RpcHandler]]] = {}
        self.proc_sites: List[ProcSite] = []
        self._collect()
        self._closures()

    # ----------------------------------------------------- collection
    def _collect(self) -> None:
        for qual in sorted(self.graph.functions):
            fn = self.graph.functions[qual]
            if any(fn.module.modname.endswith(t)
                   for t in _EXCLUDED_MODULE_TAILS):
                continue
            sends = self._collect_sends(fn)
            if sends:
                self.rpc_sends.setdefault(fn.module.modname, []).extend(sends)
            for handler in self._collect_handlers(fn):
                self.rpc_handlers.setdefault(
                    fn.module.modname, {}
                ).setdefault(handler.op, []).append(handler)
            for node in own_nodes(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Attribute):
                    if node.func.attr in ("barrier", "arrive") and node.args:
                        t = _name_template(node.args[0])
                        if t is not None:
                            self.barrier_sites.append(BarrierSite(
                                fn, node, t,
                                "wait" if node.func.attr == "barrier"
                                else "arrive",
                            ))
                            continue
                    if node.func.attr in ("kill", "terminate") \
                            and not node.args:
                        self.proc_sites.append(ProcSite(fn, node, "kill"))
                        continue
                name = self.graph.resolve_name(fn, node.func)
                if name == "subprocess.Popen":
                    self.proc_sites.append(ProcSite(fn, node, "spawn"))
                elif name == "os.kill":
                    self.proc_sites.append(ProcSite(fn, node, "kill"))

    @staticmethod
    def _op_of_dict(d: ast.AST) -> Tuple[bool, Optional[str]]:
        """(is_rpc_request_dict, constant op value or None)."""
        if not isinstance(d, ast.Dict):
            return False, None
        for k, v in zip(d.keys, d.values):
            if isinstance(k, ast.Constant) and k.value == "op":
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    return True, v.value
                return True, None
        return False, None

    @staticmethod
    def _has_trace_key(d: ast.AST) -> bool:
        """The request dict carries a literal ``"trace"`` key (a
        ``None`` key means ``**spread`` — opaque, give the benefit of
        the doubt: a spread may well inject the trace)."""
        if not isinstance(d, ast.Dict):
            return False
        return any(
            k is None or (isinstance(k, ast.Constant)
                          and k.value == "trace")
            for k in d.keys
        )

    def _collect_sends(self, fn: FunctionInfo) -> List[RpcSend]:
        """Dict literals carrying an ``"op"`` key passed into a call —
        the line-JSON RPC send idiom — plus the reply keys each send's
        result is read for (direct subscripts/.get on the call, or on
        the name the call is assigned to, function-scoped)."""
        sends: List[RpcSend] = []
        send_nodes: Dict[int, RpcSend] = {}
        for node in own_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _COLLECTION_MUTATORS):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                is_rpc, op = self._op_of_dict(arg)
                if is_rpc:
                    send = RpcSend(fn, node, op,
                                   has_trace=self._has_trace_key(arg),
                                   dict_node=arg)
                    sends.append(send)
                    send_nodes[id(node)] = send
                    break
        if not sends:
            return sends
        # reply variables: reply = <send call>(...)
        reply_vars: Dict[str, RpcSend] = {}
        for node in own_nodes(fn.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and id(node.value) in send_nodes
            ):
                reply_vars[node.targets[0].id] = send_nodes[id(node.value)]
        for node in own_nodes(fn.node):
            # reply["key"] / <send call>["key"]
            if isinstance(node, ast.Subscript) and isinstance(
                node.slice, ast.Constant
            ) and isinstance(node.slice.value, str):
                send = None
                if id(node.value) in send_nodes:
                    send = send_nodes[id(node.value)]
                elif isinstance(node.value, ast.Name) \
                        and node.value.id in reply_vars:
                    send = reply_vars[node.value.id]
                if send is not None:
                    send.reads.append((node.slice.value, node))
            # reply.get("key") / <send call>.get("key")
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                base = node.func.value
                send = None
                if id(base) in send_nodes:
                    send = send_nodes[id(base)]
                elif isinstance(base, ast.Name) and base.id in reply_vars:
                    send = reply_vars[base.id]
                if send is not None:
                    send.reads.append((node.args[0].value, node))
        return sends

    @staticmethod
    def _op_var_of(fn: FunctionInfo) -> Optional[str]:
        """The local bound from ``<req>.get("op")`` / ``<req>["op"]`` —
        the dispatch variable of a server handler."""
        for node in own_nodes(fn.node):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            v = node.value
            if (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Attribute)
                and v.func.attr == "get"
                and v.args
                and isinstance(v.args[0], ast.Constant)
                and v.args[0].value == "op"
            ):
                return node.targets[0].id
            if (
                isinstance(v, ast.Subscript)
                and isinstance(v.slice, ast.Constant)
                and v.slice.value == "op"
            ):
                return node.targets[0].id
        return None

    def _collect_handlers(self, fn: FunctionInfo) -> List[RpcHandler]:
        op_var = self._op_var_of(fn)
        if op_var is None:
            return []
        handlers: List[RpcHandler] = []
        for node in own_nodes(fn.node):
            if not isinstance(node, ast.If):
                continue
            test = node.test
            if not (
                isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id == op_var
                and len(test.ops) == 1
                and isinstance(test.ops[0], ast.Eq)
                and isinstance(test.comparators[0], ast.Constant)
                and isinstance(test.comparators[0].value, str)
            ):
                continue
            handler = RpcHandler(fn, node, test.comparators[0].value)
            for sub in node.body:
                for n in ast.walk(sub):
                    if isinstance(n, ast.Return) and isinstance(
                        n.value, ast.Dict
                    ):
                        for k in n.value.keys:
                            if isinstance(k, ast.Constant) and isinstance(
                                k.value, str
                            ):
                                handler.reply_keys.add(k.value)
            handlers.append(handler)
        return handlers

    # ------------------------------------------------------- closures
    def _reverse_edges(self) -> Dict[str, Set[str]]:
        rev: Dict[str, Set[str]] = {}
        for caller, callees in self.graph.edges.items():
            for c in callees:
                rev.setdefault(c, set()).add(caller)
        # virtual dispatch: whoever calls the abstract method reaches
        # the override — for upward propagation the override's effects
        # belong to the abstract surface too
        for abstract, overrides in self.graph.override_edges.items():
            for o in overrides:
                rev.setdefault(o, set()).add(abstract)
        return rev

    @staticmethod
    def _propagate_up(rev: Dict[str, Set[str]],
                      direct: Dict[str, Set[str]]) -> Dict[str, Set[str]]:
        """Transitive closure toward CALLERS: every function inherits
        the union of its callees' sets."""
        out: Dict[str, Set[str]] = {k: set(v) for k, v in direct.items()}
        work = list(direct)
        while work:
            q = work.pop()
            vals = out.get(q, set())
            for caller in rev.get(q, ()):
                cur = out.setdefault(caller, set())
                add = vals - cur
                if add:
                    cur |= add
                    work.append(caller)
        return out

    def _closures(self) -> None:
        graph = self.graph
        rev = self._reverse_edges()

        # barrier templates each function (transitively) waits/arrives at
        direct_waits: Dict[str, Set[str]] = {}
        direct_arrives: Dict[str, Set[str]] = {}
        for site in self.barrier_sites:
            d = direct_waits if site.kind == "wait" else direct_arrives
            d.setdefault(site.fn.qualname, set()).add(site.name)
        self.trans_waits = self._propagate_up(rev, direct_waits)
        self.trans_arrives = self._propagate_up(rev, direct_arrives)

        # shared-side-effect closure (STA012) + guard-establisher
        # closure (STA014): both propagate from functions whose OWN
        # body performs the thing toward their callers
        effect_direct: Dict[str, Set[str]] = {}
        guard_direct: Dict[str, Set[str]] = {}
        span_direct: Dict[str, Set[str]] = {}
        self.span_regions: Dict[str, Set[int]] = {}
        span_seeds: Set[str] = set()
        for qual in graph.functions:
            fn = graph.functions[qual]
            local_types = graph._local_types(fn)
            regions = self._span_regions_of(fn)
            if regions:
                self.span_regions[qual] = regions
                span_direct[qual] = {"span"}
                for node in own_nodes(fn.node):
                    if isinstance(node, ast.Call) and \
                            getattr(node, "lineno", 0) in regions:
                        t = graph.resolve_callable(fn, node.func, local_types)
                        if t is not None:
                            span_seeds.add(t.qualname)
            for node in own_nodes(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                if self._direct_effect(fn, node, local_types):
                    effect_direct[qual] = {"effect"}
                if self._establishes_guard(fn, node):
                    guard_direct[qual] = {"guard"}
        self.effectful = set(self._propagate_up(rev, effect_direct))
        self.guard_establishers = set(guard_direct)
        self.guard_closure = set(self._propagate_up(rev, guard_direct))
        self.span_enterers = set(self._propagate_up(rev, span_direct))
        self.span_covered = graph.descendants(span_seeds, virtual=True)

        # STA011-style guard context (fault-firing callers, retry_io
        # callables) — virtual so abstract-surface calls flow through
        seeds, self.retry_regions = _guard_seeds(graph)
        self.guarded_ctx = graph.descendants(seeds, virtual=True)

    def _direct_effect(self, fn: FunctionInfo, node: ast.Call,
                       local_types) -> bool:
        """Does this call perform a shared side-effect in its own right
        (fault fire, retry/raw I/O, control-plane mutation, RPC-ish)?"""
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "fire" and node.args and isinstance(
                node.args[0], ast.Constant
            ):
                return True
            if f.attr in _CP_EFFECT_ATTRS:
                return True
            if f.attr in _RAW_IO_ATTRS:
                return True
        name = self.graph.resolve_name(fn, f)
        if name in _RAW_IO_NAMES or name == "subprocess.Popen":
            return True
        if name and name.rsplit(".", 1)[-1] == "retry_io":
            return True
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            is_rpc, _ = self._op_of_dict(arg)
            if is_rpc:
                return True
        return False

    def _establishes_guard(self, fn: FunctionInfo, node: ast.Call) -> bool:
        """retry_io or ANY FaultPlan fire (process points included —
        a kill drill covers a kill site for STA014)."""
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "fire" and node.args \
                and isinstance(node.args[0], ast.Constant):
            return True
        name = self.graph.resolve_name(fn, f)
        return bool(name and name.rsplit(".", 1)[-1] == "retry_io")

    def _span_regions_of(self, fn: FunctionInfo) -> Set[int]:
        """Line numbers lexically inside ``with span(...)`` /
        ``with obs.span(...)`` / ``with self._span(...)`` bodies."""
        regions: Set[int] = set()
        for node in own_nodes(fn.node):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                ctx = item.context_expr
                if not isinstance(ctx, ast.Call):
                    continue
                f = ctx.func
                is_span = (
                    isinstance(f, ast.Attribute)
                    and f.attr in ("span", "_span")
                ) or (isinstance(f, ast.Name) and f.id == "span")
                if not is_span:
                    name = self.graph.resolve_name(fn, f)
                    is_span = bool(
                        name and name.rsplit(".", 1)[-1] == "span"
                    )
                if is_span:
                    for stmt in node.body:
                        regions.update(range(
                            stmt.lineno,
                            getattr(stmt, "end_lineno", stmt.lineno) + 1,
                        ))
                    break
        return regions

    # ------------------------------------------------- coverage helpers
    def site_guarded(self, fn: FunctionInfo, node: ast.Call) -> bool:
        if fn.qualname in self.guarded_ctx:
            return True
        if getattr(node, "lineno", 0) in self.retry_regions.get(
            fn.qualname, ()
        ):
            return True
        if fn.qualname in self.guard_establishers:
            return True
        target = self.graph.resolve_callable(fn, node.func)
        return target is not None and target.qualname in self.guard_closure

    def site_spanned(self, fn: FunctionInfo, node: ast.Call) -> bool:
        if getattr(node, "lineno", 0) in self.span_regions.get(
            fn.qualname, ()
        ):
            return True
        if fn.qualname in self.span_covered:
            return True
        target = self.graph.resolve_callable(fn, node.func)
        return target is not None and target.qualname in self.span_enterers


# ======================================================== STA012
@dataclasses.dataclass
class _Path:
    steps: List[Tuple[int, Tuple, ast.AST]]  # (stmt id, events, node)
    exit_kind: Optional[str] = None  # return / raise / exit / fall
    exit_node: Optional[ast.AST] = None
    flag_sanctioned: bool = False
    # branch outcomes: id(If stmt) -> (took body?, stmt node). Used to
    # reject cross-host-infeasible path pairs: two hosts cannot take
    # different sides of a UNIFORM test (cp.num_hosts), whatever else
    # differs between their paths.
    choices: Dict[int, Tuple[bool, ast.AST]] = dataclasses.field(
        default_factory=dict
    )

    def extended(self, frag: "_Path") -> "_Path":
        return _Path(
            self.steps + frag.steps,
            frag.exit_kind,
            frag.exit_node,
            self.flag_sanctioned or frag.flag_sanctioned,
            {**self.choices, **frag.choices},
        )


def _mentions_abort(test: ast.AST) -> bool:
    """The sanctioned drain check: the branch condition consults the
    abort flag (``get_flag(ABORT_FLAG)``) or an abort-named value."""
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and "abort" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "abort" in n.attr.lower():
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and n.value.lower() == "abort":
            return True
    return False


class _PathEnumerator:
    """Bounded statement-level path enumeration of one function body,
    carrying barrier/effect events per statement."""

    def __init__(self, model: ProtocolModel, fn: FunctionInfo):
        self.model = model
        self.graph = model.graph
        self.fn = fn
        self.local_types = self.graph._local_types(fn)
        self.truncated = False

    # -------------------------------------------------------- events
    def _expr_events(self, expr: ast.AST) -> Tuple:
        events: List[Tuple] = []
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                events.extend(self._call_events(n))
        return tuple(events)

    def _call_events(self, call: ast.Call) -> List[Tuple]:
        f = call.func
        if isinstance(f, ast.Attribute) and call.args:
            if f.attr == "barrier":
                t = _name_template(call.args[0])
                if t is not None:
                    return [("wait", t)]
            if f.attr == "arrive":
                t = _name_template(call.args[0])
                if t is not None:
                    return [("arrive", t)]
        name = self.graph.resolve_name(self.fn, f)
        if name in ("sys.exit", "os._exit"):
            return [("exit",)]
        if self.model._direct_effect(self.fn, call, self.local_types):
            return [("effect",)]
        target = self.graph.resolve_callable(self.fn, f, self.local_types)
        if target is not None:
            events: List[Tuple] = []
            for w in sorted(self.model.trans_waits.get(target.qualname, ())):
                events.append(("wait", w))
            for a in sorted(
                self.model.trans_arrives.get(target.qualname, ())
            ):
                events.append(("arrive", a))
            if target.qualname in self.model.effectful:
                events.append(("effect",))
            return events
        return []

    # --------------------------------------------------------- paths
    def paths(self, stmts: List[ast.stmt]) -> List[_Path]:
        out = self._seq(stmts)
        for p in out:
            if p.exit_kind is None:
                p.exit_kind = "fall"
                p.exit_node = p.steps[-1][2] if p.steps else self.fn.node
        return out

    def _seq(self, stmts: List[ast.stmt]) -> List[_Path]:
        paths = [_Path(steps=[])]
        for stmt in stmts:
            live = [p for p in paths if p.exit_kind is None]
            done = [p for p in paths if p.exit_kind is not None]
            if not live:
                break
            frags = self._stmt(stmt)
            combined: List[_Path] = []
            for p in live:
                for frag in frags:
                    combined.append(p.extended(frag))
                    if len(combined) + len(done) > MAX_PATHS:
                        self.truncated = True
                        break
                if self.truncated:
                    break
            paths = done + combined
        return paths

    def _step(self, stmt: ast.stmt, events: Tuple) -> Tuple[int, Tuple,
                                                            ast.AST]:
        return (id(stmt), events, stmt)

    def _stmt(self, stmt: ast.stmt) -> List[_Path]:
        if isinstance(stmt, ast.Return):
            ev = self._expr_events(stmt.value) if stmt.value else ()
            return [_Path([self._step(stmt, ev)], "return", stmt)]
        if isinstance(stmt, ast.Raise):
            return [_Path([self._step(stmt, ())], "raise", stmt)]
        if isinstance(stmt, ast.If):
            head = self._expr_events(stmt.test)
            abort = _mentions_abort(stmt.test)
            out: List[_Path] = []
            for taken, body in ((True, stmt.body), (False, stmt.orelse)):
                branch = self._seq(body) if body else [_Path(steps=[])]
                for b in branch:
                    hp = _Path([self._step(stmt, head)], None, None,
                               abort and taken)
                    hp.choices[id(stmt)] = (taken, stmt)
                    out.append(hp.extended(b))
            return out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head_expr = stmt.test if isinstance(stmt, ast.While) \
                else stmt.iter
            head = self._expr_events(head_expr)
            out = [_Path([self._step(stmt, head)])]  # loop not taken
            for b in self._seq(list(stmt.body)):
                out.append(_Path([self._step(stmt, head)]).extended(b))
            for b in self._seq(list(stmt.orelse)) if stmt.orelse else []:
                out.append(_Path([self._step(stmt, head)]).extended(b))
            return out
        if isinstance(stmt, ast.Try):
            out = list(self._seq(list(stmt.body)))
            for handler in stmt.handlers:
                out.extend(self._seq(list(handler.body)))
            if stmt.orelse:
                body_paths = out
                out = []
                for p in body_paths:
                    if p.exit_kind is None:
                        for o in self._seq(list(stmt.orelse)):
                            out.append(p.extended(o))
                    else:
                        out.append(p)
            if stmt.finalbody:
                final = self._seq(list(stmt.finalbody))
                merged: List[_Path] = []
                for p in out:
                    if p.exit_kind is None:
                        for fp in final:
                            merged.append(p.extended(fp))
                    else:
                        merged.append(p)
                out = merged
            return out
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            head_events: List[Tuple] = []
            for item in stmt.items:
                head_events.extend(self._expr_events(item.context_expr))
            out = []
            for b in self._seq(list(stmt.body)):
                out.append(
                    _Path([self._step(stmt, tuple(head_events))]).extended(b)
                )
            return out
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return [_Path([self._step(stmt, ())])]
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return [_Path([self._step(stmt, ())])]
        # simple statement: events from every expression inside it;
        # a bare `sys.exit()` expression statement is an exit path
        ev = self._expr_events(stmt)
        if ("exit",) in ev:
            return [_Path([self._step(stmt, ev)], "exit", stmt)]
        return [_Path([self._step(stmt, ev)])]


def _barrier_exemptions(fn: FunctionInfo) -> Set[str]:
    from .concurrency import _annotation_comments

    out: Set[str] = set()
    for _, text in _annotation_comments(fn.module, fn.node):
        m = _BARRIER_EXEMPT_RE.search(text)
        if m:
            out.update(
                t.strip() for t in m.group(1).split(",") if t.strip()
            )
    return out


def _rendezvouses(p: _Path, name: str,
                  kinds: Tuple[str, ...] = ("wait", "arrive")) -> bool:
    for _, events, _ in p.steps:
        for ev in events:
            if ev[0] in kinds and ev[1] == name:
                return True
    return False


def _divergence(p: _Path, r: _Path) -> Tuple[bool, Optional[ast.AST]]:
    """(shared side-effect in the common prefix, statement where the
    pair diverged). Any event in the common prefix counts as an
    effect — a heartbeat, an I/O, an arrival at ANOTHER barrier are
    all state a peer observes. The divergence statement is the last
    common step (the branching If/loop header)."""
    k = 0
    effect = False
    n = min(len(p.steps), len(r.steps))
    while k < n and p.steps[k][0] == r.steps[k][0]:
        if p.steps[k][1]:
            effect = True
        k += 1
    div = p.steps[k - 1][2] if k > 0 else None
    return effect, div


def _uniform_divergence(div: Optional[ast.AST]) -> bool:
    """A branch on cluster topology (``cp.num_hosts > 1``) is uniform:
    every participant takes the SAME side, so the skipping branch
    cannot strand a peer — there are no peers when it is taken."""
    if not isinstance(div, (ast.If, ast.While)):
        return False
    for n in ast.walk(div.test):
        if isinstance(n, ast.Attribute) and "num_hosts" in n.attr:
            return True
        if isinstance(n, ast.Name) and "num_hosts" in n.id:
            return True
    return False


def _feasible_pair(p: _Path, r: _Path) -> bool:
    """Can two HOSTS take these two paths concurrently? Not if the
    paths disagree on any uniform (topology) test — num_hosts is the
    same number everywhere, so every host branches the same way,
    wherever else their state diverges."""
    for sid, (choice, node) in p.choices.items():
        other = r.choices.get(sid)
        if other is not None and other[0] != choice \
                and _uniform_divergence(node):
            return False
    return True


def check_barrier_divergence(model: ProtocolModel,
                             em: Optional[_Emitter] = None) -> List:
    """STA012 over every function owning a named-barrier wait site."""
    em = em or _Emitter()
    by_fn: Dict[str, List[BarrierSite]] = {}
    for site in model.barrier_sites:
        if site.kind == "wait":
            by_fn.setdefault(site.fn.qualname, []).append(site)
    for qual in sorted(by_fn):
        fn = model.graph.functions[qual]
        enum = _PathEnumerator(model, fn)
        paths = enum.paths(list(fn.node.body))
        if enum.truncated:
            continue  # bounded: skip rather than flag half-enumerated
        exempt = _barrier_exemptions(fn)
        names = sorted({s.name for s in by_fn[qual]})
        for name in names:
            if name in exempt or "*" in exempt:
                continue
            # the conflict is SKIP vs WAIT: a peer is only stranded on
            # a path that actually parks at the barrier. Arrive-only
            # paths (the preempt broadcast) park nobody — they release
            # peers — so they are not in the comparison set, though
            # having one DOES sanction the skipping path itself below.
            rendezvous = [p for p in paths
                          if _rendezvouses(p, name, kinds=("wait",))]
            if not rendezvous:
                continue
            seen_exits: Set[int] = set()
            for p in paths:
                if _rendezvouses(p, name):
                    continue
                if p.exit_kind in ("raise", "exit"):
                    continue  # loud exits: the supervisor owns crashes
                if p.flag_sanctioned:
                    continue  # abort-flag drain
                hazardous = False
                for r in rendezvous:
                    if not _feasible_pair(p, r):
                        continue  # disagree on a uniform topology test
                    effect, div = _divergence(p, r)
                    if effect and not _uniform_divergence(div):
                        hazardous = True
                        break
                if not hazardous:
                    continue  # diverged before any shared work, or on
                    # a uniform topology test (same side on every host)
                node = p.exit_node or fn.node
                line = getattr(node, "lineno", 0)
                if line in seen_exits:
                    continue
                seen_exits.add(line)
                em.emit(
                    "STA012", fn.module, node,
                    f"exit path in {fn.dotted} skips barrier {name!r} "
                    "after shared side-effects another path rendezvouses "
                    "on — a peer parked inside the barrier waits out the "
                    "full timeout (the split-exit deadlock). "
                    "Register arrival on this path (cp.arrive), raise "
                    "instead of returning, or annotate "
                    f"'# sta: barrier-exempt({name})' with a comment "
                    "saying why this exit is safe",
                )
    return em.findings


# ======================================================== STA013
def check_rpc_contract(model: ProtocolModel,
                       em: Optional[_Emitter] = None) -> List:
    """STA013: per-module client-op set vs server dispatch table."""
    em = em or _Emitter()
    for modname in sorted(set(model.rpc_sends) | set(model.rpc_handlers)):
        sends = model.rpc_sends.get(modname, [])
        handlers = model.rpc_handlers.get(modname, {})
        if not handlers:
            continue  # client-only module: no co-located table to check
        sent_ops = {s.op for s in sends if s.op is not None}
        for send in sends:
            if send.op is None:
                continue
            if send.op not in handlers:
                em.emit(
                    "STA013", send.fn.module, send.node,
                    f"client op {send.op!r} ({send.fn.dotted}) has no "
                    f"handler in {modname}'s dispatch table — the reply "
                    "will be the unknown-op error envelope",
                )
                continue
            reply_keys = set(_ENVELOPE_KEYS)
            for h in handlers[send.op]:
                reply_keys |= h.reply_keys
            for key, node in send.reads:
                if key not in reply_keys:
                    em.emit(
                        "STA013", send.fn.module, node,
                        f"client reads reply key {key!r} for op "
                        f"{send.op!r} ({send.fn.dotted}) but no handler "
                        "path returns it — that read is always "
                        "None/KeyError territory",
                    )
        for op in sorted(handlers):
            if op not in sent_ops:
                for h in handlers[op]:
                    em.emit(
                        "STA013", h.fn.module, h.node,
                        f"handler for op {op!r} ({h.fn.dotted}) is never "
                        f"sent by any client in {modname} — dead dispatch "
                        "arm (or the client moved modules without its "
                        "table)",
                    )
    return em.findings


# ======================================================== STA014
def check_edge_coverage(model: ProtocolModel,
                        em: Optional[_Emitter] = None,
                        scope_dirs: Iterable[str] = PROTOCOL_SCOPE_DIRS
                        ) -> List:
    """STA014: RPC sends, barrier waits, and replica spawn/kill sites
    must be guarded (fault point / retry_io) AND spanned."""
    em = em or _Emitter()
    sites: List[Tuple[FunctionInfo, ast.Call, str]] = []
    for sends in model.rpc_sends.values():
        for s in sends:
            sites.append((s.fn, s.node, f"rpc send {s.op!r}"))
    for b in model.barrier_sites:
        if b.kind == "wait":
            sites.append((b.fn, b.node, f"barrier wait {b.name!r}"))
    for p in model.proc_sites:
        sites.append((p.fn, p.node, f"replica {p.kind}"))
    sites.sort(key=lambda t: (t[0].module.rel,
                              getattr(t[1], "lineno", 0)))
    for fn, node, label in sites:
        if not _in_scope(fn.module.rel, scope_dirs):
            continue
        guarded = model.site_guarded(fn, node)
        spanned = model.site_spanned(fn, node)
        if guarded and spanned:
            continue
        missing = []
        if not guarded:
            missing.append("a FaultPlan point / retry_io guard")
        if not spanned:
            missing.append("an obs.span")
        em.emit(
            "STA014", fn.module, node,
            f"{label} in {fn.dotted} lacks {' and '.join(missing)} — "
            "the protocol layer extends the STA011 contract: every "
            "rpc/barrier/spawn/kill edge takes fault-or-retry coverage "
            "AND a span (docs/ANALYSIS.md, Protocol rules); wire it "
            "through or suppress with a comment saying why",
        )
    return em.findings


# ======================================================== STA016
# trace-propagation scope: the serving fleet only. Control-plane
# envelopes (resilience/) are deliberately exempt — their cross-host
# identity is DERIVED at both ends (``obs.derive_trace_id`` over the
# lease / commit key), never carried in the envelope, so demanding a
# "trace" key there would add dead payload the consumer ignores.
TRACE_SCOPE_DIRS = ("serve",)


def check_trace_propagation(model: ProtocolModel,
                            em: Optional[_Emitter] = None,
                            scope_dirs: Iterable[str] = TRACE_SCOPE_DIRS
                            ) -> List:
    """STA016: every serve/ RPC request dict literal must carry a
    literal ``"trace"`` key (value may be ``None`` — key presence IS
    the contract; ``obs/trace.py`` reassembles cross-host timelines
    from what the envelopes carry, and one bare envelope severs the
    request's trace at a process boundary)."""
    em = em or _Emitter()
    flat = sorted(
        (s for sends in model.rpc_sends.values() for s in sends),
        key=lambda s: (s.fn.module.rel, getattr(s.node, "lineno", 0)),
    )
    for s in flat:
        if not _in_scope(s.fn.module.rel, scope_dirs):
            continue
        if s.has_trace:
            continue
        em.emit(
            "STA016", s.fn.module, s.dict_node or s.node,
            f"rpc send {s.op!r} in {s.fn.dotted} carries no "
            "literal 'trace' key — serve/ envelopes must propagate "
            "the ambient trace context (obs.current_trace(), even "
            "when None) or a failover re-dispatch severs the "
            "request's distributed trace (docs/OBSERVABILITY.md, "
            "Tracing); add the key or suppress with a comment "
            "saying why",
        )
    return em.findings


# ------------------------------------------------------------- entry point
def check_protocol(graph: CallGraph) -> List:
    """All four protocol rules over one shared graph + model."""
    model = ProtocolModel(graph)
    findings: List = []
    findings.extend(check_barrier_divergence(model))
    findings.extend(check_rpc_contract(model))
    findings.extend(check_edge_coverage(model))
    findings.extend(check_trace_propagation(model))
    return findings


# ---------------------------------------------------------- inventory
def _fn_label(fn: FunctionInfo) -> str:
    return f"{fn.module.modname}.{fn.dotted}"


def build_inventory(graph: CallGraph,
                    model: Optional[ProtocolModel] = None) -> dict:
    """The goldens-pinned protocol surface: barrier name templates with
    their participating functions, and per-module RPC op tables
    (clients, handler, reply keys). Structural — any drift (a renamed
    barrier, a dropped handler, a new op) diffs loudly."""
    model = model or ProtocolModel(graph)
    barriers: Dict[str, Dict[str, List[str]]] = {}
    for site in model.barrier_sites:
        rec = barriers.setdefault(site.name, {"waits": [], "arrives": []})
        key = "waits" if site.kind == "wait" else "arrives"
        label = _fn_label(site.fn)
        if label not in rec[key]:
            rec[key].append(label)
    for rec in barriers.values():
        rec["waits"].sort()
        rec["arrives"].sort()
    rpc: Dict[str, dict] = {}
    for modname in sorted(set(model.rpc_sends) | set(model.rpc_handlers)):
        sends = model.rpc_sends.get(modname, [])
        handlers = model.rpc_handlers.get(modname, {})
        ops: Dict[str, dict] = {}
        for op in sorted(
            {s.op for s in sends if s.op is not None} | set(handlers)
        ):
            op_sends = [s for s in sends if s.op == op]
            hs = handlers.get(op, [])
            reply_keys: Set[str] = set()
            for h in hs:
                reply_keys |= h.reply_keys
            ops[op] = {
                "clients": sorted({_fn_label(s.fn) for s in op_sends}),
                "handler": sorted({_fn_label(h.fn) for h in hs}),
                "reply_keys": sorted(reply_keys),
                "reads": sorted(
                    {k for s in op_sends for k, _ in s.reads}
                ),
            }
        rpc[modname] = {"ops": ops}
    return {
        "schema_version": 1,
        "barriers": {
            name: barriers[name] for name in sorted(barriers)
        },
        "rpc": rpc,
    }


def golden_path(golden_dir: Optional[Path] = None) -> Path:
    base = golden_dir or Path(__file__).parent / "goldens"
    return Path(base) / "protocol.json"


def write_inventory(inv: dict, golden_dir: Optional[Path] = None) -> Path:
    path = golden_path(golden_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(inv, indent=1, sort_keys=True) + "\n")
    return path


def _diff(prefix: str, golden, current, out: List[str]) -> None:
    if isinstance(golden, dict) and isinstance(current, dict):
        for k in sorted(set(golden) | set(current)):
            if k not in golden:
                out.append(f"{prefix}{k}: added (not in golden)")
            elif k not in current:
                out.append(f"{prefix}{k}: removed (golden has it)")
            else:
                _diff(f"{prefix}{k}.", golden[k], current[k], out)
        return
    if golden != current:
        out.append(f"{prefix.rstrip('.')}: golden {golden!r} != "
                   f"current {current!r}")


def compare_inventory(inv: dict,
                      golden_dir: Optional[Path] = None) -> List[str]:
    """Drift lines against the pinned golden; a missing golden is one
    drift line (repin to create it deliberately)."""
    path = golden_path(golden_dir)
    if not path.exists():
        return [f"protocol golden missing: {path} (run "
                "`python -m scaling_tpu_torch.analysis protocol --repin`)"]
    golden = json.loads(path.read_text())
    out: List[str] = []
    _diff("protocol.", golden, inv, out)
    return out
