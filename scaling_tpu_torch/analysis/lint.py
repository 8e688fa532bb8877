"""Static lint over the port's source (AST pass, no torch import;
counterpart of ``scaling_tpu/analysis/lint.py``).

Rules — stable IDs (the JAX package's), severities, and the contexts
they fire in:

========  ========  ==========================================================
ID        severity  meaning
========  ========  ==========================================================
STA001    error     (JAX: a Python branch on a traced array.) Eager PyTorch
                    has no traced context: a branch on a tensor is a host
                    sync, which STA003 and STA010 police. Never fires.
STA002    error     (JAX: a numpy op on a traced value.) No traced context
                    in eager PyTorch: numpy on a device tensor raises at
                    run time, on the CPU it is correct. Never fires.
STA003    error     host sync inside a kernel wrapper (a function that
                    counts a launch in ``ops.launches.KERNEL``) or inside
                    ``forward`` / ``backward`` of a
                    ``torch.autograd.Function``: ``.item()`` /
                    ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
                    ``.synchronize()`` / ``torch.cuda.synchronize`` /
                    ``np.asarray()`` / ``float()`` / ``int()`` /
                    ``bool()`` on tensor values (stalls the launch queue
                    the kernel is meant to feed).
STA004    error     generator reuse: one ``torch.Generator`` consumed by
                    two draws (``generator=g``) with no ``g.manual_seed``
                    or reassignment in between, or one seed expression
                    handed to ``manual_seed`` twice in a function (the
                    same stream twice). The dropout sites
                    seed one generator a draw from ``site_seed(key,
                    site)``, so a mask never depends on draw order.
STA005    warning   mutable default argument value.
STA006    warning   dtype literal that bypasses the configured precision
                    policy (hardcoded ``torch.float16`` / ``torch.float64``
                    / ``torch.half`` / ``torch.double`` or numpy's f16/f64
                    in model code; the policy admits bf16/f32 via
                    ``precision`` config only).
STA007    error     swallowed exception in resilience-critical code
                    (``trainer/``, ``checkpoint/``, ``data/``,
                    ``resilience/``, ``runner/``, ``obs/``, ``serve/``,
                    ``tune/``): a bare ``except:`` / ``except Exception``
                    / ``except BaseException`` handler that neither
                    re-raises, logs, nor uses the bound exception.
STA008    error     (JAX: a stage-shift ``jnp.concatenate`` that XLA's SPMD
                    partitioner miscompiled under a vmapped stage.) The
                    port has no SPMD partitioner. Never fires.
STA009    error     lock-discipline race: an instance attribute mutated
                    on one thread (a ``threading.Thread(target=...)``
                    entry point's reachable set) and read/written on
                    another (the class's main-thread public API)
                    without a common ``with self.<lock>:`` guard on
                    both paths. Whole-program rule (concurrency.py);
                    ``# sta: lock(<attr>)`` declares deliberate
                    lock-free fields.
STA010    error     device sync on the hot path: ``torch.cuda.synchronize``
                    / ``.synchronize()`` / ``.item()`` / ``.cpu()`` /
                    ``.to("cpu")``, and ``.tolist()`` / ``.numpy()`` /
                    ``float()`` / ``int()`` / ``bool()`` /
                    ``np.asarray()`` on device values in code reachable
                    from the trainer step dispatch, the serve tick, or
                    the fleet router dispatch. Whole-program rule
                    (concurrency.py).
STA011    error     raw I/O (``open``/``os.replace``/``os.write``/
                    sockets/``Path.read_text``-family) in the gated
                    subsystems (resilience/, serve/, runner/, obs/,
                    checkpoint/) not reachable under ``retry_io`` or a
                    ``FaultPlan`` point. Whole-program rule
                    (concurrency.py).
STA012    error     barrier-divergence: an exit path (return /
                    fall-through) skips a named control-plane barrier
                    that another path rendezvouses on, AFTER a shared
                    side-effect in their common prefix (one host enters
                    ``commit:step-N``, a peer exits early; the barrier
                    never fills). ``raise``/``sys.exit`` exits, abort-
                    flag-checked drains, ``cp.arrive`` paths, and
                    ``# sta: barrier-exempt(<name>)`` are sanctioned.
                    Whole-program rule (protocol.py).
STA013    error     RPC-contract mismatch between a module's client
                    send sites (dict literals with an ``"op"`` key)
                    and its server dispatch table: an op with no
                    handler, a dead handler no client sends, a reply
                    key a client reads that no handler path returns.
                    Whole-program rule (protocol.py).
STA014    error     protocol-edge coverage: an RPC send, named-barrier
                    wait, or replica spawn/kill site in the gated
                    subsystems (+ trainer/) not under a ``FaultPlan``
                    point / ``retry_io`` guard or not inside/beneath an
                    ``obs.span``. Whole-program rule (protocol.py).
STA015    warning   stale suppression: a ``# sta: disable=...`` comment
                    on a line where no (suppressed) finding fires, or a
                    ``# sta: lock(attr)`` annotation suppressing no
                    cross-thread hazard. Emitted by the whole-program
                    pass only.
STA016    error     trace-propagation: an RPC request dict literal (an
                    ``"op"`` key) in serve/ without a literal
                    ``"trace"`` key: every envelope crossing a process
                    boundary carries the ambient trace context, even as
                    None. Control-plane envelopes (resilience/) are
                    exempt: their cross-host identity is derived at both
                    ends. Whole-program rule (protocol.py).
========  ========  ==========================================================

Suppress a finding on its line with ``# sta: disable=STA003`` (a comma
rule list, ``# sta: disable=STA009,STA011``, suppresses exactly those
rules) or a bare ``# sta: disable`` (every rule on the line). Suppressed
findings are still reported (with ``suppressed: true``) but do not fail
the gate. STA015 itself is deliberately NOT silenced by the bare form
(a stale bare disable would self-suppress); an explicit
``# sta: disable=STA015`` in the comment's rule list is honored.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

RULES = {
    "STA001": ("error", "python branch on a traced-array expression "
                        "(no traced context in eager PyTorch: never fires)"),
    "STA002": ("error", "numpy host op on a traced value (no traced "
                        "context in eager PyTorch: never fires)"),
    "STA003": ("error", "host sync inside a kernel wrapper or an "
                        "autograd Function's forward/backward"),
    "STA004": ("error", "torch.Generator or seed consumed by two draws "
                        "without a new seed"),
    "STA005": ("warning", "mutable default argument"),
    "STA006": ("warning", "dtype literal bypasses the precision policy"),
    "STA007": ("error", "swallowed exception (broad except without "
                        "re-raise/logging/use)"),
    "STA008": ("error", "stage-shift concatenate under an SPMD partitioner "
                        "(the port has none: never fires)"),
    "STA009": ("error", "cross-thread attribute access without a common "
                        "lock guard on both paths"),
    "STA010": ("error", "device sync reachable from the trainer step / "
                        "serve tick hot path"),
    "STA011": ("error", "raw I/O in a gated subsystem outside every "
                        "retry_io / FaultPlan guard"),
    "STA012": ("error", "exit path skips a barrier another path "
                        "rendezvouses on after shared side-effects"),
    "STA013": ("error", "RPC op/reply contract mismatch between client "
                        "sends and the server dispatch table"),
    "STA014": ("error", "protocol edge (rpc send / barrier wait / replica "
                        "spawn-kill) missing fault/retry guard or span"),
    "STA015": ("warning", "stale suppression: a '# sta:' annotation that "
                          "no longer suppresses any finding"),
    "STA016": ("error", "serve/ RPC request dict without a literal "
                        "'trace' key — the envelope must carry the "
                        "ambient trace context"),
}

# Model code for the precision policy (STA006): the layers, the kernels'
# wrappers and the transformer layer stack.
TRACED_MODULE_DIRS = (
    "nn",
    "parallel",
    "ops",
    "models/transformer/layers",
)

# Directory allowlist for STA007: the layers that stand between a fault
# and a lost run (a torn checkpoint, a dead data mount, a worker the
# supervisor should have relaunched), telemetry that must not eat its own
# failures, the serving loop, and the tuner's calibration and config I/O.
SWALLOW_SCOPE_DIRS = (
    "trainer",
    "checkpoint",
    "data",
    "resilience",
    "runner",
    "obs",
    "serve",
    "tune",
)

# calls that count as "the handler surfaced the problem"
_LOG_CALL_ATTRS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log", "print_exc", "print_exception",
}

# torch random draws that CONSUME their generator's state (a second draw
# from one generator makes a mask depend on the order of the draws)
_KEY_CONSUMERS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson",
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_", "dropout",
}

# host syncs (STA003): methods that sync whatever they are called on, and
# methods that sync when called on a tensor
_SYNC_METHODS = {"item", "cpu", "synchronize"}
_SYNC_METHODS_TAINTED = {"tolist", "numpy"}

_SUPPRESS_RE = re.compile(r"#\s*sta:\s*disable(?:=([A-Za-z0-9_, ]+))?")


def iter_comments(source: str) -> List[Tuple[int, str]]:
    """(lineno, text) for every actual COMMENT token. Annotation scans
    (``# sta: disable`` / ``lock(...)`` / ``barrier-exempt(...)``) go
    through here so a docstring QUOTING an annotation — this package's
    own docs are full of them — neither suppresses anything nor trips
    the stale-suppression audit. Falls back to a whole-line scan only
    when the source does not tokenize (the syntax-error path, where
    nothing downstream runs anyway)."""
    import io
    import tokenize

    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return [(i, text) for i, text in
                enumerate(source.splitlines(), start=1) if "#" in text]
    return out


def parse_suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """line -> suppressed rule set (None = bare disable, every rule).
    Shared by the per-file pass and the whole-program rules
    (concurrency.py) so ``# sta: disable=STA009,STA011`` means the same
    thing everywhere. Only real comments count (see iter_comments)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, text in iter_comments(source):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        if m.group(1):
            out[i] = {r.strip().upper() for r in m.group(1).split(",")
                      if r.strip()}
        else:
            out[i] = None  # bare disable: every rule
    return out


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        sup = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{sup}"


# --------------------------------------------------------------- name maps
class _Aliases:
    """Canonicalize attribute chains through the module's imports:
    ``F.silu`` -> ``torch.nn.functional.silu``, ``np.asarray`` ->
    ``numpy.asarray``, ``partial`` -> ``functools.partial``."""

    def __init__(self, tree: ast.Module):
        self.map: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.map[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    self.map[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted canonical name of a Name/Attribute chain, or None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.map.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))


def _contains(node: ast.AST, pred) -> bool:
    return any(pred(n) for n in ast.walk(node))


# Tensor metadata is host data by construction: ``int(x.shape[0])``,
# ``x.size(1)`` or ``x.data_ptr() % 16`` are not host syncs.
_STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "size", "numel", "dim",
                 "stride", "data_ptr", "element_size", "is_contiguous",
                 "itemsize", "nbytes", "is_cuda", "requires_grad", "layout")


def _walk_skip_static(node: ast.AST):
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            continue  # don't descend: `x.shape` never carries device data
        if isinstance(n, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops
        ):
            continue  # `scale_k is not None`: a host bool
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _is_tensor_call(aliases: _Aliases, node: ast.AST) -> bool:
    """A ``torch.*`` call that returns a tensor (``torch.cuda.*`` and the
    other host-side namespaces excluded)."""
    if not isinstance(node, ast.Call):
        return False
    name = aliases.resolve(node.func)
    return bool(
        name and name.startswith("torch.")
        and not name.startswith(("torch.cuda.", "torch.backends.",
                                 "torch.utils.", "torch.distributed."))
        and name not in ("torch.device", "torch.dtype", "torch.finfo",
                         "torch.iinfo", "torch.Size", "torch.is_tensor")
    )


def _contains_tensor(aliases: _Aliases, node: ast.AST, names: Set[str]) -> bool:
    """Does ``node`` reference a tensor-valued name or a tensor call,
    ignoring metadata attribute chains?"""
    return any(
        (isinstance(n, ast.Name) and n.id in names)
        or _is_tensor_call(aliases, n)
        for n in _walk_skip_static(node)
    )


def _annotation_is_host(ann: Optional[ast.AST]) -> bool:
    """A parameter annotated with a host type (``int``, ``float``,
    ``bool``, ``str``, ``tuple``...) carries no tensor."""
    if ann is None:
        return False
    text = ast.unparse(ann)
    return "Tensor" not in text and any(
        t in text for t in ("int", "float", "bool", "str", "tuple", "Tuple",
                            "dtype", "device", "Sequence", "list", "List")
    )


# ------------------------------------------------------------ module lint
class _ModuleLint:
    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.aliases = _Aliases(self.tree)
        self.findings: List[Finding] = []
        self.suppressions = self._parse_suppressions(source)
        norm = rel.replace("\\", "/")
        self.in_traced_dir = any(
            f"/{d}/" in f"/{norm}" or norm.startswith(f"scaling_tpu_torch/{d}/")
            for d in TRACED_MODULE_DIRS
        )
        self.in_swallow_scope = any(
            f"/{d}/" in f"/{norm}" or norm.startswith(f"scaling_tpu_torch/{d}/")
            for d in SWALLOW_SCOPE_DIRS
        )
        self.is_config_module = Path(rel).name == "config.py"
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    @staticmethod
    def _parse_suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
        return parse_suppressions(source)

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        rules_at = self.suppressions.get(line, "absent")
        suppressed = rules_at is None or (
            isinstance(rules_at, set) and rule in rules_at
        )
        severity = RULES[rule][0]
        self.findings.append(
            Finding(rule, severity, self.rel, line,
                    getattr(node, "col_offset", 0), message, suppressed)
        )


    # ------------------------------------------- sync-free function set
    def _sync_free_functions(self) -> Set[ast.AST]:
        """The functions STA003 holds to "no host sync": kernel wrappers
        (a body that counts a launch in ``launches.KERNEL``) and
        ``forward`` / ``backward`` of ``torch.autograd.Function``
        subclasses, plus anything nested inside those."""
        funcs = [
            n for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        out: Set[ast.AST] = set()

        def counts_kernel_launch(fn) -> bool:
            for n in ast.walk(fn):
                if not (isinstance(n, ast.Call) and n.args):
                    continue
                name = self.aliases.resolve(n.func)
                counter = self.aliases.resolve(n.args[0])
                if (name and name.rsplit(".", 1)[-1] == "add" and counter
                        and counter.rsplit(".", 1)[-1] == "KERNEL"):
                    return True
            return False

        def autograd_function(cls) -> bool:
            return any(
                (self.aliases.resolve(b) or "").endswith("autograd.Function")
                or (self.aliases.resolve(b) or "") == "Function"
                for b in cls.bases
            )

        for fn in funcs:
            parent = self._parents.get(fn)
            if isinstance(parent, ast.ClassDef) and fn.name in (
                "forward", "backward"
            ) and autograd_function(parent):
                out.add(fn)
            elif counts_kernel_launch(fn):
                out.add(fn)
        # closure: anything nested inside one of them
        changed = True
        while changed:
            changed = False
            for fn in funcs:
                if fn in out:
                    continue
                p = self._parents.get(fn)
                while p is not None:
                    if p in out:
                        out.add(fn)
                        changed = True
                        break
                    p = self._parents.get(p)
        return out

    # ------------------------------------------------------- rule passes
    def run(self) -> List[Finding]:
        for fn in self._sync_free_functions():
            self._check_sync_free_function(fn)
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_mutable_defaults(node)
                self._check_key_reuse(node)
        if self.in_traced_dir and not self.is_config_module:
            self._check_dtype_policy()
        if self.in_swallow_scope:
            self._check_swallowed_exceptions()
        return self.findings

    # ------------------------------------------------------ STA007 pass
    def _check_swallowed_exceptions(self) -> None:
        """A broad handler must do SOMETHING with the exception: re-raise,
        log it (any ``logger``-style method, ``warnings.warn``, ``print``,
        ``traceback.print_exc``), or at least reference the bound name
        (propagating it by other means, e.g. queueing it for a consumer).
        """
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad_catch(node.type):
                continue
            if not self._handler_surfaces(node):
                caught = (
                    "bare except" if node.type is None
                    else f"except {self.aliases.resolve(node.type) or '...'}"
                )
                self._emit(
                    "STA007", node,
                    f"{caught} swallows the exception (no re-raise, no "
                    "logging, bound name unused); faults in this layer "
                    "must surface",
                )

    def _is_broad_catch(self, type_node: Optional[ast.AST]) -> bool:
        if type_node is None:
            return True  # bare except:
        types = (
            list(type_node.elts)
            if isinstance(type_node, ast.Tuple)
            else [type_node]
        )
        for t in types:
            name = self.aliases.resolve(t)
            if name and name.rsplit(".", 1)[-1] in ("Exception", "BaseException"):
                return True
        return False

    def _handler_surfaces(self, handler: ast.ExceptHandler) -> bool:
        bound = handler.name
        for n in ast.walk(handler):
            if isinstance(n, ast.Raise):
                return True
            if isinstance(n, ast.Call):
                fname = self.aliases.resolve(n.func)
                if fname in ("print", "warnings.warn", "traceback.print_exc"):
                    return True
                if (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr in _LOG_CALL_ATTRS
                ):
                    return True
            if (
                bound
                and isinstance(n, ast.Name)
                and n.id == bound
                and isinstance(n.ctx, ast.Load)
            ):
                return True
        return False

    # ------------------------------------------------------ STA003 pass
    def _own_nodes(self, fn: ast.AST) -> Iterable[ast.AST]:
        """Walk ``fn``'s body without descending into nested functions
        (each nested function is checked on its own)."""
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))


    def _tensor_names(self, fn) -> Set[str]:
        """Parameters that may hold tensors (not ``self``/``cls``/``ctx``,
        not annotated with a host type, not defaulted to a host constant)
        + anything (transitively) assigned from them or from a tensor
        call — tuple unpacking included."""
        args = fn.args
        defaults = dict(zip(
            [a.arg for a in (args.posonlyargs + args.args)][::-1],
            list(args.defaults)[::-1],
        ))
        defaults.update({a.arg: d for a, d in zip(args.kwonlyargs,
                                                  args.kw_defaults)
                         if d is not None})
        # an unannotated parameter is a tensor when the body reads an
        # attribute of it (``q.shape``, ``x.data_ptr()``); one only handed
        # to ``float()`` is a host scalar (``sm_scale``, ``eps``)
        used_as_object = {
            n.value.id for n in self._own_nodes(fn)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
        }
        names = set()
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.arg in ("self", "cls", "ctx"):
                continue
            if a.annotation is None:
                if a.arg not in used_as_object:
                    continue
            elif _annotation_is_host(a.annotation):
                continue
            d = defaults.get(a.arg)
            if isinstance(d, ast.Constant) and d.value is not None:
                continue  # sm_scale: float = 1.0
            names.add(a.arg)

        def tainted(value: ast.AST) -> bool:
            return _contains_tensor(self.aliases, value, names)

        changed = True
        while changed:
            changed = False
            for node in self._own_nodes(fn):
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign) and tainted(node.value):
                    targets = list(node.targets)
                elif (
                    isinstance(node, (ast.AnnAssign, ast.AugAssign))
                    and node.value is not None
                    and tainted(node.value)
                ):
                    targets = [node.target]
                elif isinstance(node, ast.For) and tainted(node.iter):
                    targets = [node.target]
                for tgt in targets:
                    for el in ast.walk(tgt):
                        if isinstance(el, ast.Name) and el.id not in names:
                            names.add(el.id)
                            changed = True
        return names

    def _check_sync_free_function(self, fn) -> None:
        """STA003 over one kernel wrapper / autograd forward or backward."""
        names = self._tensor_names(fn)

        def is_tensor(node: ast.AST) -> bool:
            return _contains_tensor(self.aliases, node, names)

        where = (f"{fn.name}() (a kernel wrapper or an autograd "
                 "Function's pass)")
        for node in self._own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            fname = self.aliases.resolve(node.func)
            if fname == "torch.cuda.synchronize":
                self._emit("STA003", node,
                           f"torch.cuda.synchronize in {where} drains the "
                           "launch queue")
            elif fname in ("float", "int", "bool") and node.args and \
                    is_tensor(node.args[0]):
                self._emit("STA003", node,
                           f"{fname}() on a tensor in {where} blocks on a "
                           "device->host transfer")
            elif fname in ("numpy.asarray", "numpy.array") and node.args \
                    and is_tensor(node.args[0]):
                self._emit("STA003", node,
                           f"{fname.replace('numpy', 'np')}() on a tensor in "
                           f"{where} is a host sync")
            elif isinstance(node.func, ast.Attribute) and not node.args and (
                node.func.attr in _SYNC_METHODS
                or (node.func.attr in _SYNC_METHODS_TAINTED
                    and is_tensor(node.func.value))
            ):
                self._emit("STA003", node,
                           f".{node.func.attr}() in {where} is a host sync")

    # ------------------------------------------------------ STA004 pass
    def _check_key_reuse(self, fn) -> None:
        """Statement-aware scan: a draw's USES evaluate before the
        statement's own ASSIGNS (``g = gen(); x = rand(generator=g)`` is
        fine, a second draw from ``g`` is not), and mutually exclusive
        if/else branches each get their own copy of the consumed state
        (one draw per branch is fine; a draw in either branch conflicts
        with a later one). ``g.manual_seed(s)`` gives ``g`` a new key and
        consumes the seed expression ``s``."""
        self._seed_names: Dict[str, Set[str]] = {}
        self._scan_key_stmts(list(fn.body), {})

    def _key_expr_events(self, node: ast.AST, last_use: Dict[str, int],
                         with_assigns: bool = False) -> None:
        uses: List[Tuple[int, int, str, str]] = []
        assigns: List[str] = []
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested functions scanned on their own
            if isinstance(n, ast.Call):
                name = self.aliases.resolve(n.func) or ""
                tail = name.rsplit(".", 1)[-1] if name else (
                    n.func.attr if isinstance(n.func, ast.Attribute) else "")
                gen = next((kw.value for kw in n.keywords
                            if kw.arg == "generator"), None)
                if tail in _KEY_CONSUMERS and isinstance(gen, ast.Name):
                    uses.append((n.lineno, n.col_offset, gen.id,
                                 f"generator {gen.id!r}"))
                if (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr == "manual_seed"
                    and isinstance(n.func.value, ast.Name)
                    and n.args
                ):
                    # a new key for the generator, drawn from the seed
                    assigns.append(n.func.value.id)
                    seed = "seed:" + ast.dump(n.args[0])
                    self._seed_names[seed] = {
                        m.id for m in ast.walk(n.args[0])
                        if isinstance(m, ast.Name)
                    }
                    uses.append((n.lineno, n.col_offset, seed,
                                 f"seed {ast.unparse(n.args[0])}"))
            targets: List[ast.AST] = []
            if with_assigns and isinstance(n, ast.Assign):
                targets = list(n.targets)
            elif with_assigns and isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            elif isinstance(n, ast.NamedExpr):
                targets = [n.target]
            for tgt in targets:
                for el in ast.walk(tgt):
                    if isinstance(el, ast.Name):
                        assigns.append(el.id)
            stack.extend(ast.iter_child_nodes(n))
        for line, col, key, what in sorted(uses):
            if key in last_use:
                self._emit(
                    "STA004",
                    _Loc(line, col),
                    f"{what} already consumed at line {last_use[key]}; "
                    "seed a new generator before drawing again",
                )
            else:
                last_use[key] = line
        for name in assigns:  # RHS evaluates first: assigns clear AFTER uses
            self._clear_key(name, last_use)

    def _clear_key(self, name: str, last_use: Dict[str, int]) -> None:
        """``name`` was rebound: its generator key, and every consumed
        seed expression that reads it, are fresh again."""
        last_use.pop(name, None)
        for seed, names in self._seed_names.items():
            if name in names:
                last_use.pop(seed, None)

    def _assign_targets(self, tgt: ast.AST, last_use: Dict[str, int]) -> None:
        for el in ast.walk(tgt):
            if isinstance(el, ast.Name):
                self._clear_key(el.id, last_use)

    def _scan_key_stmts(
        self, stmts: List[ast.AST], last_use: Dict[str, int]
    ) -> Dict[str, int]:
        for st in stmts:
            if isinstance(
                st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(st, ast.If):
                self._key_expr_events(st.test, last_use)
                b1 = self._scan_key_stmts(list(st.body), dict(last_use))
                b2 = self._scan_key_stmts(list(st.orelse), dict(last_use))
                last_use = {**b1, **b2}
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._key_expr_events(st.iter, last_use)
                self._assign_targets(st.target, last_use)
                last_use = self._scan_key_stmts(list(st.body), last_use)
                last_use = self._scan_key_stmts(list(st.orelse), last_use)
            elif isinstance(st, ast.While):
                self._key_expr_events(st.test, last_use)
                last_use = self._scan_key_stmts(list(st.body), last_use)
                last_use = self._scan_key_stmts(list(st.orelse), last_use)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    self._key_expr_events(item.context_expr, last_use)
                    if item.optional_vars is not None:
                        self._assign_targets(item.optional_vars, last_use)
                last_use = self._scan_key_stmts(list(st.body), last_use)
            elif isinstance(st, ast.Try):
                merged = self._scan_key_stmts(list(st.body), dict(last_use))
                for h in st.handlers:
                    merged = {
                        **merged,
                        **self._scan_key_stmts(list(h.body), dict(last_use)),
                    }
                last_use = self._scan_key_stmts(list(st.orelse), merged)
                last_use = self._scan_key_stmts(list(st.finalbody), last_use)
            else:
                self._key_expr_events(st, last_use, with_assigns=True)
        return last_use

    # ------------------------------------------------------ STA005 pass
    def _check_mutable_defaults(self, fn) -> None:
        for default in list(fn.args.defaults) + [
            d for d in fn.args.kw_defaults if d is not None
        ]:
            mutable = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set", "bytearray")
            )
            if mutable:
                self._emit(
                    "STA005", default,
                    f"mutable default argument in {fn.name}(); "
                    "default to None and construct inside",
                )


    # ------------------------------------------------------ STA006 pass
    def _check_dtype_policy(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Attribute):
                name = self.aliases.resolve(node)
                if name in (
                    "torch.float16", "torch.float64", "torch.half",
                    "torch.double", "numpy.float16", "numpy.float64",
                ):
                    self._emit(
                        "STA006", node,
                        f"hardcoded {name} bypasses the configured "
                        "precision policy (config.precision decides "
                        "bf16/f32)",
                    )
            elif isinstance(node, ast.Call):
                is_cast = (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("astype", "to")
                )
                for kw in node.keywords:
                    if (
                        kw.arg == "dtype"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value in ("float16", "float64")
                    ):
                        self._emit(
                            "STA006", kw.value,
                            f"dtype string {kw.value.value!r} bypasses the "
                            "precision policy",
                        )
                if is_cast and node.args:
                    a = node.args[0]
                    if isinstance(a, ast.Constant) and a.value in (
                        "float16", "float64"
                    ):
                        self._emit(
                            "STA006", a,
                            f"{node.func.attr}({a.value!r}) bypasses the "
                            "precision policy",
                        )
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("half", "double")
                        and not node.args):
                    self._emit(
                        "STA006", node,
                        f".{node.func.attr}() bypasses the precision policy",
                    )


class _Loc:
    """Synthetic location carrier for findings not tied to one node."""

    def __init__(self, lineno: int, col_offset: int):
        self.lineno = lineno
        self.col_offset = col_offset


# ------------------------------------------------------------- public API
def lint_file(path: Path, root: Optional[Path] = None) -> List[Finding]:
    root = root or Path.cwd()
    try:
        rel = str(path.resolve().relative_to(root.resolve()))
    except ValueError:
        rel = str(path)
    source = path.read_text()
    try:
        return _ModuleLint(path, rel, source).run()
    except SyntaxError as e:
        return [
            Finding("STA000", "error", rel, e.lineno or 0, e.offset or 0,
                    f"syntax error: {e.msg}")
        ]


def _stale_disables(
    files: List[Path], root: Path, findings: List[Finding]
) -> List[Finding]:
    """STA015 (disable half): every ``# sta: disable[=rules]`` comment
    must suppress at least one finding that actually fires on its line
    (restricted to the listed rules when a list is given). Emitted
    unsuppressed by design — a stale bare disable must not silence its
    own staleness finding; an explicit ``disable=STA015`` is honored
    (and marks the comment intentional)."""
    by_loc: Dict[Tuple[str, int], Set[str]] = {}
    for f in findings:
        if f.suppressed:
            by_loc.setdefault((f.path, f.line), set()).add(f.rule)
    out: List[Finding] = []
    for path in files:
        try:
            rel = str(path.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(path)
        try:
            source = path.read_text()
        except OSError:
            continue
        for line, rules in sorted(parse_suppressions(source).items()):
            if rules is not None and "STA015" in rules:
                continue  # explicitly opted out / self-referential
            fired = by_loc.get((rel, line), set())
            live = fired if rules is None else (fired & rules)
            if live:
                continue
            listed = "" if rules is None else "=" + ",".join(sorted(rules))
            out.append(Finding(
                "STA015", RULES["STA015"][0], rel, line, 0,
                f"stale '# sta: disable{listed}': no finding fires on "
                "this line any more — remove the comment so it cannot "
                "pre-suppress the next real finding here",
                False,
            ))
    return out


def lint_paths(
    paths: Iterable[Path | str],
    root: Optional[Path] = None,
    program: bool = True,
    graph=None,
) -> List[Finding]:
    """Lint every ``.py`` under ``paths`` (files or directories).

    Runs the per-file AST rules (STA001-STA008) plus — unless
    ``program=False`` — the whole-program call-graph rules
    (STA009-STA014, concurrency.py + protocol.py) and the
    stale-suppression audit (STA015) over the same path set as one
    analysis unit. Pass ``graph`` (a prebuilt ``CallGraph`` over the
    same paths) to skip the rebuild — the CLI constructs one graph per
    run and shares it across commands. Ordering is stable:
    (path, line, col, rule)."""
    root = Path(root) if root else Path.cwd()
    # materialize once: a generator argument would be exhausted by the
    # per-file loop and silently hand check_program an EMPTY path set
    paths = [Path(p) for p in paths]
    findings: List[Finding] = []
    seen_files: List[Path] = []
    for p in paths:
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f, root))
            seen_files.append(f)
    if program:
        from .concurrency import check_program

        findings.extend(check_program(paths, root=root, graph=graph))
        # stale-disable audit LAST: it needs the complete finding set
        # (per-file + whole-program) to judge what a comment suppresses
        findings.extend(_stale_disables(seen_files, root, findings))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
