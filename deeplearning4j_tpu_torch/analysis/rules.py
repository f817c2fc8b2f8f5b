"""The dl4j-lint ruleset of the port: machine checks for the fused-path
contract.

Port of ``deeplearning4j_tpu/analysis/rules.py``. Every rule states an
invariant the fused paths rely on but no test asserts directly:

- ``host-sync-in-hot-path``   — no ``float()``/``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``/``.to("cpu")``/``np.asarray``/
  ``torch.cuda.synchronize`` reachable from a hot root (``@traced`` or
  ``HOT_PATH_REGISTRY``): a captured step must not read back to the host.
- ``implicit-f32-promotion``  — no matmul operand that reaches a param
  without the port's compute cast (``policy.cast_compute`` /
  ``compute_copy``).
- ``recompile-hazard``        — no unhashable / object-typed values in
  program-cache keys (``_epoch_steps``, ``_programs`` and friends).
- ``lock-discipline``         — no attribute mutated from more than one
  thread entry point without a common lock.
- ``bare-counter``            — no ad-hoc ``self._*_counter`` attributes
  outside ``monitor/``.
- ``marker-audit``            — chaos-behavior tests carry the ``chaos``
  marker; slow sleeps carry ``slow``; only registered markers are used.
- ``adhoc-out-shardings``     — no ``NamedSharding`` built (nor
  ``out_shardings=`` passed) outside ``parallel/sharding_registry.py``.

Two rules of the reference have no construct to check in the port and
are left out:

- ``rng-reuse`` checks that a ``jax.random`` key is not consumed twice.
  A ``torch.Generator`` is stateful: each draw advances it, so two
  consumers of one generator draw different numbers. What takes its
  place is the seeding discipline (one generator per epoch from
  ``(seed, epoch)``, ``nlp/epoch_kernels.epoch_generator``) and the
  replay seams the parity tests feed.
- ``donation-consistency`` checks that an argument given to
  ``donate_argnums`` is not read after the call. The port donates
  nothing: a captured step writes its static state in place, which
  contract 2 of ``analysis/contracts.py`` checks on the programs
  themselves (every state tensor keeps its storage across a step).

Rules are AST heuristics scoped to this codebase's idioms — module-local
call graphs, bare-name hot registries. They do not execute or import the
code under analysis.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.analysis.annotations import HOT_PATH_REGISTRY
from deeplearning4j_tpu_torch.analysis.engine import (
    Finding,
    LintConfig,
    Module,
    Rule,
)

__all__ = ["ALL_RULES"]

#: the package whose monitor/ and sharding registry the path rules name
PACKAGE = "deeplearning4j_tpu_torch"


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' when not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def iter_defs(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def own_body_walk(fn: ast.AST):
    """Walk ``fn``'s body WITHOUT descending into nested def/class bodies
    (nested defs are separate call-graph nodes)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def has_decorator(fn, *names: str) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        d = dotted(target)
        if d and (d in names or d.split(".")[-1] in names):
            return True
    return False


# ---------------------------------------------------------------------------
# host-sync-in-hot-path
# ---------------------------------------------------------------------------

SYNC_CALL_NAMES = {
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
    "torch.cuda.synchronize",
}
SYNC_ATTR_CALLS = {"item", "tolist", "cpu", "numpy", "synchronize"}

# profile-readback: the monitor/profile + monitor/memory collection
# entry points (program profiles, device memory stats, live-tensor
# walks) are host readbacks by design and are only permitted at CHUNK
# BOUNDARIES — drive_epoch_chunks calls them between chunks. Any of
# these reachable from a hot root would stall the captured step behind
# a host sync, so the host-sync rule flags them like float().
PROFILE_READBACK_CALLS = {
    "capture_program_profile",
    "sample_hbm_watermark",
    "validate_cache_budget",
    "cache_resident_bytes",
    "live_array_bytes",
}

# ledger/flight collection: the run-ledger boundary marks and flight-
# recorder writes (monitor/ledger, monitor/flight) are host-side
# control-plane calls permitted ONLY at chunk boundaries — the same
# contract as the profile readbacks. One of these inside a captured
# step would run once at capture and never again on replay.
LEDGER_FLIGHT_CALLS = {
    "ledger_run_start",
    "ledger_chunk_start",
    "ledger_chunk_done",
    "ledger_run_end",
    "flight_record",
}


def hot_functions(module: Module) -> Set[ast.AST]:
    """The module's HOT function/lambda scopes: ``@traced`` defs and
    ``HOT_PATH_REGISTRY`` names, closed over the module-local call graph
    (bare callee names) and containment edges (nested defs AND lambdas
    run inside their parent's trace). Shared by the host-sync and
    implicit-f32-promotion rules so "inside a traced hot path" means
    the same thing to both."""
    defs = list(iter_defs(module.tree))
    by_name: Dict[str, List[ast.AST]] = {}
    for fn in defs:
        by_name.setdefault(fn.name, []).append(fn)

    scopes = defs + [n for n in ast.walk(module.tree)
                     if isinstance(n, ast.Lambda)]
    callees: Dict[ast.AST, Set[str]] = {}
    children: Dict[ast.AST, List[ast.AST]] = {}
    for fn in scopes:
        names: Set[str] = set()
        for node in own_body_walk(fn):
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d:
                    names.add(d.split(".")[-1])
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef,
                                   ast.Lambda)):
                children.setdefault(fn, []).append(node)
        callees[fn] = names

    hot: Set[ast.AST] = set()
    work = [fn for fn in defs
            if fn.name in HOT_PATH_REGISTRY
            or has_decorator(fn, "traced")]
    while work:
        fn = work.pop()
        if fn in hot:
            continue
        hot.add(fn)
        work.extend(children.get(fn, []))
        for callee_name in callees.get(fn, ()):
            for target in by_name.get(callee_name, ()):
                if target not in hot:
                    work.append(target)
    return hot


class HostSyncRule(Rule):
    id = "host-sync-in-hot-path"
    doc = ("host-synchronizing call (float()/.item()/.tolist()/.cpu()/"
           ".numpy()/.to('cpu')/np.asarray/torch.cuda.synchronize, a "
           "profile-readback like sample_hbm_watermark/"
           "capture_program_profile, or a ledger/flight collection "
           "call like ledger_chunk_done/flight_record — "
           "chunk-boundary-only by contract) reachable from a @traced "
           "function or a HOT_PATH_REGISTRY root")

    def check(self, module: Module, config: LintConfig) -> List[Finding]:
        hot = hot_functions(module)

        out: List[Finding] = []
        for fn in hot:
            for node in own_body_walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                msg = None
                d = dotted(node.func)
                if (isinstance(node.func, ast.Name)
                        and node.func.id == "float"
                        and not self._host_scalar_arg(node)):
                    msg = ("float() forces a device->host sync on traced "
                           "values")
                elif d in SYNC_CALL_NAMES:
                    msg = f"{d}() materializes device data on the host"
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in SYNC_ATTR_CALLS):
                    msg = (f".{node.func.attr}() forces a device->host "
                           "sync")
                elif self._to_cpu(node):
                    msg = ".to('cpu') copies device data to the host"
                elif (d and d.split(".")[-1] in PROFILE_READBACK_CALLS):
                    msg = (f"{d}() is a profile-readback (compile "
                           "introspection / device memory_stats) — "
                           "profile collection is only permitted at "
                           "chunk boundaries, never")
                elif (d and d.split(".")[-1] in LEDGER_FLIGHT_CALLS):
                    msg = (f"{d}() is a run-ledger/flight-recorder "
                           "collection call — ledger transitions and "
                           "flight records are only permitted at chunk "
                           "boundaries, never")
                if msg:
                    scope = getattr(fn, "name", "<lambda>")
                    self.emit(out, module, node,
                              f"{msg} inside hot path '{scope}' "
                              "(reachable from a traced root)")
        return out

    @staticmethod
    def _to_cpu(call: ast.Call) -> bool:
        """``t.to("cpu")`` / ``t.to(device="cpu")``."""
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr == "to"):
            return False
        args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                      if kw.arg == "device"]
        return any(isinstance(a, ast.Constant) and a.value == "cpu"
                   for a in args)

    @staticmethod
    def _host_scalar_arg(call: ast.Call) -> bool:
        """float(len(...)) / float(<literal>) convert host scalars, not
        traced values — never a device sync."""
        if len(call.args) != 1:
            return False
        arg = call.args[0]
        if isinstance(arg, ast.Constant):
            return True
        return (isinstance(arg, ast.Call)
                and isinstance(arg.func, ast.Name)
                and arg.func.id == "len")


# ---------------------------------------------------------------------------
# implicit-f32-promotion
# ---------------------------------------------------------------------------

# contraction entry points whose operand dtype decides the tensor-core
# rate
MATMUL_CALL_NAMES = {"einsum", "matmul", "mm", "bmm", "addmm", "baddbmm",
                     "linear", "dot", "tensordot"}
# wrappers that make the operand's dtype EXPLICIT (the policy casts, a
# direct .to(dtype), or the master-weights per-step copy)
CAST_CALL_NAMES = {"cast_compute", "cast_param", "cast_output", "to",
                   "type", "compute_copy"}


class ImplicitF32PromotionRule(Rule):
    id = "implicit-f32-promotion"
    doc = ("matmul/einsum operand inside a traced hot path reaches a "
           "param leaf (a string-keyed subscript like params['W'] / "
           "blk['attn']['wq'], or a name bound from one) without "
           "passing through policy.cast_compute — under the bf16 "
           "policy an f32 leaf runs the whole contraction at the f32 "
           "rate instead of the bf16 tensor-core rate")

    def check(self, module: Module, config: LintConfig) -> List[Finding]:
        out: List[Finding] = []
        for fn in hot_functions(module):
            param_names = self._param_bound_names(fn)
            for node in own_body_walk(fn):
                operands = self._matmul_operands(node)
                for op in operands:
                    leaf = self._uncast_param_ref(op, param_names)
                    if leaf is None:
                        continue
                    scope = getattr(fn, "name", "<lambda>")
                    self.emit(
                        out, module, node,
                        f"matmul operand '{leaf}' reaches a param leaf "
                        "without policy.cast_compute inside hot path "
                        f"'{scope}' — an f32 leaf here runs the "
                        "contraction off the bf16 tensor-core rate")
        return out

    @staticmethod
    def _matmul_operands(node: ast.AST) -> List[ast.expr]:
        if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                      ast.MatMult):
            return [node.left, node.right]
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d and d.split(".")[-1] in MATMUL_CALL_NAMES:
                # skip einsum specs / dimension-number tuples — only
                # array-shaped operands carry a dtype
                return [a for a in node.args
                        if not isinstance(a, (ast.Constant, ast.Tuple))]
        return []

    @classmethod
    def _param_bound_names(cls, fn: ast.AST) -> Set[str]:
        """Names bound (flow-insensitively) from a param-leaf expression
        within ``fn`` — one level of propagation, enough for the
        ``w = blk['attn']['wq']; x @ w`` idiom. A name REbound through a
        cast call does not count."""
        param: Set[str] = set()
        cast: Set[str] = set()
        for node in own_body_walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if not isinstance(target, ast.Name):
                    continue
                if cls._is_cast_call(node.value):
                    cast.add(target.id)
                elif cls._is_param_subscript(node.value):
                    param.add(target.id)
        return param - cast

    @staticmethod
    def _is_cast_call(expr: ast.AST) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        d = dotted(expr.func)
        return bool(d) and d.split(".")[-1] in CAST_CALL_NAMES

    @staticmethod
    def _is_param_subscript(expr: ast.AST) -> bool:
        """String-keyed subscript — the pytree-leaf access idiom
        (``params['embed']``, ``blk['mlp']['w1']``). Integer/variable
        indexing (batch gathers like ``xs[i]``) is data, not params."""
        return (isinstance(expr, ast.Subscript)
                and isinstance(expr.slice, ast.Constant)
                and isinstance(expr.slice.value, str))

    @classmethod
    def _uncast_param_ref(cls, expr: ast.AST,
                          param_names: Set[str]) -> Optional[str]:
        """The offending source text when ``expr`` reaches a param leaf
        with no cast wrapper on the path; None when clean."""
        if cls._is_cast_call(expr):
            return None
        if cls._is_param_subscript(expr):
            return ast.unparse(expr) if hasattr(ast, "unparse") else "?"
        if isinstance(expr, ast.Name) and expr.id in param_names:
            return expr.id
        # unwrap transparent transforms (reshape/transpose/indexing/
        # unary) — a reshape does not change the operand's dtype
        if isinstance(expr, ast.Call):
            d = dotted(expr.func)
            attr = d.split(".")[-1] if d else ""
            if attr in ("reshape", "transpose", "ravel", "squeeze"):
                base = (expr.func.value
                        if isinstance(expr.func, ast.Attribute) else None)
                if base is not None:
                    return cls._uncast_param_ref(base, param_names)
            return None  # any other call decides its own dtype
        if isinstance(expr, ast.Subscript):
            return cls._uncast_param_ref(expr.value, param_names)
        if isinstance(expr, ast.UnaryOp):
            return cls._uncast_param_ref(expr.operand, param_names)
        return None


# ---------------------------------------------------------------------------
# recompile-hazard
# ---------------------------------------------------------------------------

CACHE_ATTR_RE = re.compile(r"^_\w*(steps|cache|programs?|jits?)\w*$")
UNHASHABLE_CTORS = {
    "list", "dict", "set", "bytearray",
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "jnp.asarray", "jnp.array",
}


class RecompileHazardRule(Rule):
    id = "recompile-hazard"
    doc = ("unhashable or object-typed value flowing into a "
           "program-cache key (_epoch_steps, _programs and friends): "
           "every lookup misses, every call rebuilds (and recaptures)")

    def check(self, module: Module, config: LintConfig) -> List[Finding]:
        out: List[Finding] = []
        for fn in iter_defs(module.tree):
            # Name -> [(lineno, value)] assignments within this fn; a use
            # resolves to the LATEST assignment at or before its line, so
            # `key = list(d); key = tuple(key)` is clean at a later use
            # and `key = (a, b); key = list(key)` is caught
            assigns: Dict[str, List[Tuple[int, ast.expr]]] = {}
            for node in own_body_walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    t = node.targets[0]
                    if isinstance(t, ast.Name):
                        assigns.setdefault(t.id, []).append(
                            (node.lineno, node.value))
            for node in own_body_walk(fn):
                key_expr = cache_name = None
                if (isinstance(node, ast.Subscript)
                        and isinstance(node.value, ast.Attribute)
                        and CACHE_ATTR_RE.match(node.value.attr)):
                    key_expr = node.slice
                    cache_name = dotted(node.value)
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Attribute)
                      and node.func.attr in ("get", "setdefault", "pop")
                      and isinstance(node.func.value, ast.Attribute)
                      and CACHE_ATTR_RE.match(node.func.value.attr)
                      and node.args):
                    key_expr = node.args[0]
                    cache_name = dotted(node.func.value)
                if key_expr is None:
                    continue
                use_line = getattr(node, "lineno", 0)
                for elt, why in self._bad_elements(key_expr, assigns,
                                                   use_line):
                    self.emit(out, module, elt,
                              f"cache key for '{cache_name}' contains "
                              f"{why} — unhashable or identity-keyed "
                              "values defeat the program cache (one "
                              "rebuild per call)")
        return out

    @staticmethod
    def _resolve(expr, assigns, use_line):
        """Latest assignment to a Name at or before ``use_line``."""
        if not isinstance(expr, ast.Name):
            return expr
        best = None
        for lineno, value in assigns.get(expr.id, ()):
            if lineno <= use_line and (best is None or lineno > best[0]):
                best = (lineno, value)
        return best[1] if best else expr

    def _bad_elements(self, key_expr, assigns, use_line):
        key_expr = self._resolve(key_expr, assigns, use_line)
        elts = (key_expr.elts if isinstance(key_expr, ast.Tuple)
                else [key_expr])
        for elt in elts:
            why = self._why_bad(self._resolve(elt, assigns, use_line))
            if why:
                yield elt, why

    @staticmethod
    def _why_bad(expr) -> Optional[str]:
        if isinstance(expr, (ast.List, ast.ListComp)):
            return "a list"
        if isinstance(expr, (ast.Dict, ast.DictComp)):
            return "a dict"
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return "a set"
        if isinstance(expr, ast.GeneratorExp):
            return "a generator (identity-hashed)"
        if isinstance(expr, ast.Lambda):
            return "a lambda (identity-hashed: a fresh object per build)"
        if isinstance(expr, ast.Call):
            d = dotted(expr.func)
            if d in UNHASHABLE_CTORS or d.split(".")[-1] in (
                    "asarray", "tolist"):
                return f"a call to {d}() (unhashable result)"
        return None


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

LOCKISH_RE = re.compile(r"lock|mutex|cond|_cv\b|\bcv\b|_mu\b", re.I)
THREAD_LAUNCH_RE = re.compile(r"(^|\.)Thread$")


class LockDisciplineRule(Rule):
    id = "lock-discipline"
    doc = ("attribute mutated from more than one thread entry point "
           "(Thread target / executor submit / signal handler) without "
           "a common lock")

    def check(self, module: Module, config: LintConfig) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                self._check_class(module, node, out)
        return out

    def _check_class(self, module: Module, cls: ast.ClassDef,
                     out: List[Finding]) -> None:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        # --- thread entry points -------------------------------------
        bg_seed_methods: Set[str] = set()
        bg_closures: List[ast.AST] = []  # nested defs handed to Thread()
        for m in methods.values():
            nested = {d.name: d for d in ast.walk(m)
                      if isinstance(d, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                      and d is not m}
            for call in ast.walk(m):
                if not isinstance(call, ast.Call):
                    continue
                d = dotted(call.func)
                target = None
                if THREAD_LAUNCH_RE.search(d or ""):
                    for kw in call.keywords:
                        if kw.arg == "target":
                            target = kw.value
                elif (isinstance(call.func, ast.Attribute)
                      and call.func.attr == "submit" and call.args):
                    target = call.args[0]
                elif d == "signal.signal" and len(call.args) >= 2:
                    target = call.args[1]
                if target is None:
                    continue
                td = dotted(target)
                if td.startswith("self."):
                    bg_seed_methods.add(td.split(".", 1)[1])
                elif isinstance(target, ast.Name) and target.id in nested:
                    bg_closures.append(nested[target.id])
        if not bg_seed_methods and not bg_closures:
            return
        # --- transitive closure over self.X() calls ------------------
        def self_callees(fn) -> Set[str]:
            names = set()
            for c in ast.walk(fn):
                if isinstance(c, ast.Call):
                    d = dotted(c.func)
                    if d.startswith("self."):
                        names.add(d.split(".", 1)[1].split(".")[0])
            return names

        bg_methods: Set[str] = set()
        work = list(bg_seed_methods)
        for closure in bg_closures:
            work.extend(n for n in self_callees(closure))
        while work:
            name = work.pop()
            if name in bg_methods or name not in methods:
                continue
            bg_methods.add(name)
            work.extend(self_callees(methods[name]))

        bg_contexts: List[Tuple[str, ast.AST]] = (
            [(n, methods[n]) for n in sorted(bg_methods)]
            + [(f"<closure {c.name}>", c) for c in bg_closures])
        closure_nodes = set(bg_closures)
        fg_contexts = [
            (n, m) for n, m in methods.items()
            if n not in bg_methods and n != "__init__"]

        # --- write sites ---------------------------------------------
        def writes(ctx_fn, skip_closures: bool):
            sites = []
            stack = list(ast.iter_child_nodes(ctx_fn))
            nodes = []
            while stack:
                node = stack.pop()
                if skip_closures and node in closure_nodes:
                    continue  # that subtree runs on the bg thread and
                    # is walked as its own bg context
                nodes.append(node)
                stack.extend(ast.iter_child_nodes(node))
            for node in nodes:
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        for sub in ast.walk(t):
                            if (isinstance(sub, ast.Attribute)
                                    and isinstance(sub.value, ast.Name)
                                    and sub.value.id == "self"):
                                attr = sub.attr
                                if LOCKISH_RE.search(attr):
                                    continue
                                sites.append(
                                    (attr, node,
                                     self._locked(module, ctx_fn, node)))
            return sites

        # closures nested in a fg method run on the bg thread: exclude
        # them from the fg method's own write set
        bg_writes: Dict[str, List[Tuple[str, ast.AST, bool]]] = {}
        for name, ctx in bg_contexts:
            for attr, node, locked in writes(ctx, skip_closures=False):
                bg_writes.setdefault(attr, []).append((name, node, locked))
        fg_writes: Dict[str, List[Tuple[str, ast.AST, bool]]] = {}
        for name, ctx in fg_contexts:
            for attr, node, locked in writes(ctx, skip_closures=True):
                fg_writes.setdefault(attr, []).append((name, node, locked))

        for attr, bsites in sorted(bg_writes.items()):
            fsites = fg_writes.get(attr, [])
            bg_names = {n for n, _, _ in bsites}
            contexts = bg_names | {n for n, _, _ in fsites}
            if len(contexts) < 2:
                continue
            unprotected = ([s for s in bsites if not s[2]]
                           + [s for s in fsites if not s[2]])
            # every unlocked site is its own finding: a suppression on
            # one (e.g. the signal-handler latch) must not silence an
            # unrelated unlocked write of the same attribute elsewhere
            for name, node, _ in unprotected:
                others = sorted(contexts - {name}) or sorted(contexts)
                self.emit(
                    out, module, node,
                    f"'{cls.name}.{attr}' is mutated from thread context "
                    f"'{name}' and also from {', '.join(others)} with at "
                    "least one unlocked write — wrap the writes in a "
                    "common lock or confine the attribute to one thread")

    @staticmethod
    def _locked(module: Module, ctx_fn, node) -> bool:
        """Is ``node`` under a ``with <something lock-ish>:`` within the
        context function?"""
        cur = module.parents.get(node)
        while cur is not None and cur is not ctx_fn:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    try:
                        text = ast.unparse(item.context_expr)
                    except Exception:  # pragma: no cover - unparse safety
                        text = dotted(item.context_expr)
                    if LOCKISH_RE.search(text):
                        return True
            cur = module.parents.get(cur)
        return False


# ---------------------------------------------------------------------------
# bare-counter
# ---------------------------------------------------------------------------

BARE_COUNTER_RE = re.compile(r"^_\w*_counter$")


class BareCounterRule(Rule):
    id = "bare-counter"
    doc = ("new bare self._*_counter attribute outside monitor/ — use "
           "monitor.record_counter()/metrics() so the value reaches the "
           "exporters")

    def check(self, module: Module, config: LintConfig) -> List[Finding]:
        if module.rel.startswith(PACKAGE + "/monitor/"):
            return []
        if not module.rel.startswith(PACKAGE + "/"):
            return []  # tests/fixtures may assign counters freely
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for sub in ast.walk(t):
                    if (isinstance(sub, ast.Attribute)
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id == "self"
                            and BARE_COUNTER_RE.match(sub.attr)):
                        self.emit(
                            out, module, node,
                            f"bare counter attribute 'self.{sub.attr}' "
                            "outside monitor/ — route it through "
                            "monitor.record_counter()/metrics() instead")
        return out


# ---------------------------------------------------------------------------
# marker-audit
# ---------------------------------------------------------------------------

PYTEST_BUILTIN_MARKS = {
    "parametrize", "skip", "skipif", "xfail", "usefixtures",
    "filterwarnings", "timeout", "flaky", "no_cover",
}
SLOW_SLEEP_S = 1.0


class MarkerAuditRule(Rule):
    id = "marker-audit"
    doc = ("pytest-marker audit: chaos-behavior tests must carry the "
           "registered 'chaos' marker, >=1s sleeps need 'slow'/'chaos', "
           "and only markers registered in pyproject.toml may be used")

    def check(self, module: Module, config: LintConfig) -> List[Finding]:
        parts = module.rel.split("/")
        if "tests" not in parts or not parts[-1].startswith("test_"):
            return []
        registered = config.markers() | PYTEST_BUILTIN_MARKS
        out: List[Finding] = []
        module_marks = self._module_marks(module)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute):
                base = dotted(node.value)
                if base == "pytest.mark" and node.attr not in registered:
                    self.emit(
                        out, module, node,
                        f"marker '{node.attr}' is not registered in "
                        "pyproject.toml [tool.pytest.ini_options] "
                        "markers (typo, or register it)")
        for fn in iter_defs(module.tree):
            if not fn.name.startswith("test_"):
                continue
            marks = (module_marks | self._own_marks(fn)
                     | self._class_marks(module, fn))
            if self._drives_chaos(fn) and "chaos" not in marks:
                self.emit(
                    out, module, fn,
                    f"test '{fn.name}' drives fault injection "
                    "(DL4J_FAULTS/faults.install/fault_point) but lacks "
                    "@pytest.mark.chaos — chaos selection (-m chaos) "
                    "will miss it")
            if not marks & {"slow", "chaos"}:
                for call in ast.walk(fn):
                    if (isinstance(call, ast.Call)
                            and dotted(call.func) in ("time.sleep",
                                                      "sleep")
                            and call.args
                            and isinstance(call.args[0], ast.Constant)
                            and isinstance(call.args[0].value,
                                           (int, float))
                            and call.args[0].value >= SLOW_SLEEP_S):
                        self.emit(
                            out, module, call,
                            f"test '{fn.name}' sleeps "
                            f"{call.args[0].value}s without "
                            "@pytest.mark.slow — tier-1 pays that wall "
                            "clock on every run")
        return out

    @staticmethod
    def _drives_chaos(fn) -> bool:
        """True when the test CODE drives fault injection — calls to
        fault_point/install_from_env/faults.install/FaultSpec or a
        DL4J_FAULTS string constant. AST-based so a docstring or comment
        that merely MENTIONS these names never demands a chaos marker."""
        doc = None
        if (fn.body and isinstance(fn.body[0], ast.Expr)
                and isinstance(fn.body[0].value, ast.Constant)
                and isinstance(fn.body[0].value.value, str)):
            doc = fn.body[0].value
        for node in ast.walk(fn):
            if node is doc:
                continue
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if (d.split(".")[-1] in ("fault_point",
                                         "install_from_env",
                                         "FaultSpec")
                        or d == "faults.install"
                        or d.endswith(".faults.install")):
                    return True
            elif isinstance(node, ast.Name) and node.id == "FaultSpec":
                return True
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and "DL4J_FAULTS" in node.value):
                return True
        return False

    @staticmethod
    def _marks_from_decorators(decorators) -> Set[str]:
        marks = set()
        for dec in decorators:
            target = dec.func if isinstance(dec, ast.Call) else dec
            d = dotted(target)
            if d.startswith("pytest.mark."):
                marks.add(d.split(".")[2])
        return marks

    def _own_marks(self, fn) -> Set[str]:
        return self._marks_from_decorators(fn.decorator_list)

    def _class_marks(self, module: Module, fn) -> Set[str]:
        marks: Set[str] = set()
        for scope in module.enclosing_scopes(fn):
            if isinstance(scope, ast.ClassDef):
                marks |= self._marks_from_decorators(scope.decorator_list)
        return marks

    def _module_marks(self, module: Module) -> Set[str]:
        marks: Set[str] = set()
        for node in module.tree.body:
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "pytestmark"
                            for t in node.targets)):
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Attribute):
                        d = dotted(sub)
                        if d.startswith("pytest.mark."):
                            marks.add(d.split(".")[2])
        return marks


# ---------------------------------------------------------------------------
# ad-hoc out_shardings / NamedSharding construction
# ---------------------------------------------------------------------------

REGISTRY_MODULE = PACKAGE + "/parallel/sharding_registry.py"


class AdhocOutShardingsRule(Rule):
    id = "adhoc-out-shardings"
    doc = ("NamedSharding constructed / out_shardings= passed outside "
           "parallel/sharding_registry.py — placement decisions belong "
           "in the per-model sharding registry (one mesh, one spec per "
           "leaf); sanctioned low-level builders carry per-site "
           "suppressions with reasons")

    def check(self, module: Module, config: LintConfig) -> List[Finding]:
        if module.rel == REGISTRY_MODULE:
            return []
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d == "NamedSharding" or d.endswith(".NamedSharding"):
                self.emit(
                    out, module, node,
                    "ad-hoc NamedSharding construction — route placement "
                    "through parallel/sharding_registry (named()/"
                    "ShardingRegistry) or suppress with a reason")
            for kw in node.keywords:
                if kw.arg == "out_shardings":
                    self.emit(
                        out, module, node,
                        "ad-hoc out_shardings= pin — source the shardings "
                        "from the model's ShardingRegistry "
                        "(epoch_out_shardings/param_shardings) or "
                        "suppress with a reason")
        return out


ALL_RULES: Tuple[Rule, ...] = (
    HostSyncRule(),
    ImplicitF32PromotionRule(),
    RecompileHazardRule(),
    LockDisciplineRule(),
    BareCounterRule(),
    MarkerAuditRule(),
    AdhocOutShardingsRule(),
)
