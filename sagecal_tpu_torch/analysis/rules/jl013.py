"""JL013: ``torch.autograd.Function`` backward completeness (counterpart
of the reference's custom_vjp cotangent completeness).

A backward that returns ``None`` for a floating-point tensor input
manufactures a zero gradient: autograd treats the slot as "no
gradient", ``.backward()`` succeeds, and an optimiser quietly never
moves that input.  On the port this is worse than in the JAX package:
the CPU takes each kernel's plain version, whose autograd gives the true
gradient, so a silent ``None`` in the CUDA Function is a gradient that
differs between the two devices.

A ``None`` slot is accepted only through one of these routes:

1. **refusal**: the backward raises when ``ctx.needs_input_grad[i]``
   asks for the slot (a test on ``needs_input_grad[i]``, or on a slice
   holding ``i``, whose body raises), or the backward always raises, or
   the ``None`` is returned under ``if not ctx.needs_input_grad[i]``;
2. **not a floating-point tensor**: the input is stored on ``ctx`` as a
   plain attribute (PyTorch's convention for non-tensor inputs), is used
   as an index (``index_select``/``gather``'s index, a subscript), is
   named as one of the port's integer index maps (``ant_p``, ``cmap``,
   ``idx``...), or every in-module ``apply`` call site passes a
   constant, a comparison, or a name the enclosing function declares
   with a non-tensor annotation or a constant default;
3. **detach guard** (the reference's stop-gradient guard): every
   in-module ``<Function>.apply(...)`` call site passes the input as
   ``x.detach()`` or a local assigned from one; at least one call site
   must exist;
4. **capability declaration**: the module declares, at top level,
   ``<FLAG> = False`` together with ``<FLAG>_ARGS = ("name", ...)``
   naming the input (``FLAG = True`` without the gradient is a finding:
   the capability promises it).

The rule also checks the backward's arity against the forward's inputs
(its parameters after ``ctx``): PyTorch raises on a mismatch only when
the backward runs, and an off-by-one misaligns every gradient after the
gap.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from sagecal_tpu_torch.analysis.callgraph import AUTOGRAD_BASES, ModuleInfo
from sagecal_tpu_torch.analysis.engine import Finding, Rule

# the port's integer index maps (int32/int64 tensors, never
# differentiable)
_INDEX_NAME_RE = re.compile(
    r"^(ant_?[pq]|cmap|chunk_map|idx|index|indices|dest|seg|pos|perm)$"
    r"|_(idx|index|map)$")
_INDEX_CALLS = {"index_select": 1, "gather": 1, "take": 0,
                "take_along_dim": 0}
_NON_TENSOR_ANNOTATIONS = {"int", "float", "bool", "str", "complex"}


def _body_walk(fdef: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested defs."""
    stack: List[ast.AST] = list(fdef.body)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _parent(node):
    return getattr(node, "_torchlint_parent", None)


def _expand(expr: ast.AST) -> Optional[List[ast.AST]]:
    """The slots of a returned tuple: literal tuples, ``+`` of tuples and
    ``(None,) * k`` with a constant ``k``; None when not static."""
    if isinstance(expr, ast.Tuple):
        return list(expr.elts)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left, right = _expand(expr.left), _expand(expr.right)
        return None if left is None or right is None else left + right
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        for seq, k in ((expr.left, expr.right), (expr.right, expr.left)):
            if isinstance(k, ast.Constant) and isinstance(k.value, int):
                elts = _expand(seq)
                if elts is not None:
                    return elts * k.value
        return None
    return None


def _returns(bwd: ast.FunctionDef
             ) -> List[Tuple[ast.Return, Optional[List[ast.AST]]]]:
    """Each return of the backward with its static slots (None when the
    returned value is not a static tuple)."""
    out = []
    for n in _body_walk(bwd):
        if isinstance(n, ast.Return) and n.value is not None:
            out.append((n, _expand(n.value)))
    return out


def _always_raises(fdef: ast.FunctionDef) -> bool:
    has_raise = False
    for n in _body_walk(fdef):
        if isinstance(n, ast.Return):
            return False
        if isinstance(n, ast.Raise):
            has_raise = True
    return has_raise


def _needs_slots(test: ast.AST, n_inputs: int) -> Set[int]:
    """Input slots a test reads off ``needs_input_grad``."""
    out: Set[int] = set()
    for n in ast.walk(test):
        if not (isinstance(n, ast.Subscript)
                and isinstance(n.value, ast.Attribute)
                and n.value.attr == "needs_input_grad"):
            continue
        sl = n.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, int):
            out.add(sl.value)
        elif isinstance(sl, ast.Slice) and sl.step is None:
            lo = sl.lower.value if isinstance(sl.lower, ast.Constant) else 0
            hi = sl.upper.value if isinstance(sl.upper, ast.Constant) \
                else n_inputs
            if isinstance(lo, int) and isinstance(hi, int):
                out.update(range(lo, hi))
    return out


def _refused_slots(bwd: ast.FunctionDef, n_inputs: int) -> Set[int]:
    """Slots whose gradient the backward refuses (raises) when asked."""
    out: Set[int] = set()
    for n in _body_walk(bwd):
        if isinstance(n, ast.If) and any(
                isinstance(s, ast.Raise) for b in n.body
                for s in ast.walk(b)):
            out |= _needs_slots(n.test, n_inputs)
    return out


def _unneeded_slots(ret: ast.Return, bwd: ast.FunctionDef,
                    n_inputs: int) -> Set[int]:
    """Slots a return sits under ``if not ctx.needs_input_grad[i]`` for."""
    out: Set[int] = set()
    cur = _parent(ret)
    while cur is not None and cur is not bwd:
        if isinstance(cur, ast.If) and isinstance(cur.test, ast.UnaryOp) \
                and isinstance(cur.test.op, ast.Not):
            out |= _needs_slots(cur.test, n_inputs)
        cur = _parent(cur)
    return out


def _ctx_stored(fwd: ast.FunctionDef, ctx: str) -> Set[str]:
    """Inputs stored on ``ctx`` as plain attributes (non-tensors, by
    PyTorch's convention), and not through ``save_for_backward``."""
    stored: Set[str] = set()
    saved: Set[str] = set()
    for n in _body_walk(fwd):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                pairs = []
                if isinstance(t, ast.Tuple) and isinstance(n.value,
                                                           ast.Tuple):
                    pairs = list(zip(t.elts, n.value.elts))
                else:
                    pairs = [(t, n.value)]
                for tgt, val in pairs:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == ctx):
                        for v in ast.walk(val):
                            if isinstance(v, ast.Name):
                                stored.add(v.id)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "save_for_backward":
            saved |= {a.id for a in n.args if isinstance(a, ast.Name)}
    return stored - saved


def _index_used(fns: List[ast.FunctionDef]) -> Set[str]:
    out: Set[str] = set()
    for fn in fns:
        for n in _body_walk(fn):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _INDEX_CALLS:
                pos = _INDEX_CALLS[n.func.attr]
                if len(n.args) > pos and isinstance(n.args[pos], ast.Name):
                    out.add(n.args[pos].id)
            elif isinstance(n, ast.Subscript):
                sl = n.slice
                elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
                out |= {e.id for e in elts if isinstance(e, ast.Name)}
    return out


def _capabilities(mi: ModuleInfo) -> Dict[str, List[Tuple[str, bool]]]:
    """input name -> [(FLAG, value)] from paired module-level
    ``FLAG = bool`` / ``FLAG_ARGS = ("name", ...)`` declarations."""
    flags: Dict[str, bool] = {}
    flag_args: Dict[str, Tuple[str, ...]] = {}
    for n in mi.tree.body:
        if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)):
            continue
        name = n.targets[0].id
        if isinstance(n.value, ast.Constant) and isinstance(n.value.value,
                                                            bool):
            flags[name] = n.value.value
        elif name.endswith("_ARGS") and isinstance(n.value,
                                                   (ast.Tuple, ast.List)):
            flag_args[name[:-len("_ARGS")]] = tuple(
                e.value for e in n.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str))
    caps: Dict[str, List[Tuple[str, bool]]] = {}
    for flag, args in flag_args.items():
        if flag in flags:
            for a in args:
                caps.setdefault(a, []).append((flag, flags[flag]))
    return caps


def _enclosing_fns(node: ast.AST) -> List[ast.AST]:
    out = []
    cur = _parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(cur)
        cur = _parent(cur)
    return out


def _detached_locals(fn: ast.AST) -> Set[str]:
    return {t.id for n in _body_walk(fn) if isinstance(n, ast.Assign)
            and _is_detach(n.value) for t in n.targets
            if isinstance(t, ast.Name)}


def _is_detach(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Call) and isinstance(expr.func,
                                                      ast.Attribute)
            and expr.func.attr == "detach")


def _non_tensor_param(fn: ast.AST, name: str) -> bool:
    """``name`` is a parameter of ``fn`` annotated as a Python scalar or
    defaulting to a constant."""
    args = fn.args
    pos = args.posonlyargs + args.args
    defaults = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    pairs = list(zip(pos, defaults)) + list(zip(args.kwonlyargs,
                                                args.kw_defaults))
    for a, d in pairs:
        if a.arg != name:
            continue
        ann = ast.unparse(a.annotation) if a.annotation is not None else ""
        if set(re.findall(r"\w+", ann)) & _NON_TENSOR_ANNOTATIONS:
            return True
        return isinstance(d, ast.Constant) and d.value is not None
    return False


class _Site:
    """How one ``apply`` call site passes one input."""

    def __init__(self, call: ast.Call, pos: int):
        self.arg = call.args[pos] if pos < len(call.args) and not any(
            isinstance(a, ast.Starred) for a in call.args[:pos + 1]) \
            else None
        self.fns = _enclosing_fns(call)

    def detached(self) -> bool:
        if self.arg is None:
            return False
        if _is_detach(self.arg):
            return True
        return (isinstance(self.arg, ast.Name) and bool(self.fns)
                and self.arg.id in _detached_locals(self.fns[0]))

    def non_tensor(self) -> bool:
        a = self.arg
        if a is None:
            return False
        if isinstance(a, (ast.Constant, ast.Compare, ast.BoolOp)) or (
                isinstance(a, ast.UnaryOp) and isinstance(a.op, ast.Not)):
            return True
        if isinstance(a, ast.Name):
            for fn in self.fns:
                if any(p.arg == a.id for p in fn.args.args
                       + fn.args.kwonlyargs + fn.args.posonlyargs):
                    return _non_tensor_param(fn, a.id)
        return False


class BackwardCompleteness(Rule):
    id = "JL013"
    title = "autograd.Function backward drops an input's gradient"

    def check(self, graph) -> Iterator[Finding]:
        for mi in graph.modules.values():
            if mi.tree is None:
                continue
            classes = [ci for ci in mi.classes.values()
                       if AUTOGRAD_BASES & set(ci.bases)]
            if classes:
                yield from self._check_module(mi, classes)

    def _check_module(self, mi, classes) -> Iterator[Finding]:
        caps = _capabilities(mi)
        for ci in classes:
            methods = {n.name: n for n in ci.node.body
                       if isinstance(n, ast.FunctionDef)}
            fwd, bwd = methods.get("forward"), methods.get("backward")
            if fwd is None or bwd is None or fwd.args.vararg is not None:
                continue
            params = [a.arg for a in fwd.args.posonlyargs + fwd.args.args]
            ctx = params[0] if params else "ctx"
            inputs = params if "setup_context" in methods else params[1:]
            if _always_raises(bwd):
                continue
            sites = [c for c in ast.walk(mi.tree)
                     if isinstance(c, ast.Call)
                     and isinstance(c.func, ast.Attribute)
                     and c.func.attr == "apply"
                     and isinstance(c.func.value, ast.Name)
                     and c.func.value.id == ci.node.name]
            refused = _refused_slots(bwd, len(inputs))
            non_tensor = (_ctx_stored(fwd, ctx)
                          | _index_used([fwd, bwd]))
            name = ci.node.name
            for ret, elts in _returns(bwd):
                if elts is None:
                    if len(inputs) != 1:
                        continue  # a tuple built elsewhere: not static
                    elts = [ret.value]
                if len(elts) != len(inputs):
                    yield self.finding(
                        mi, ret,
                        "backward of `%s` returns %d gradient(s) for %d "
                        "input(s) of its forward" % (name, len(elts),
                                                     len(inputs)),
                        symbol=f"{ci.qualname}.backward")
                    continue
                unneeded = _unneeded_slots(ret, bwd, len(inputs))
                for i, (param, elt) in enumerate(zip(inputs, elts)):
                    if not (isinstance(elt, ast.Constant)
                            and elt.value is None):
                        continue
                    if i in refused or i in unneeded:
                        continue
                    if param in non_tensor or _INDEX_NAME_RE.search(param):
                        continue
                    route = self._declared(param, i, caps, sites)
                    if route == "ok":
                        continue
                    msg = (
                        "capability flag promises a `%s` gradient but the "
                        "backward of `%s` returns None for it" % (param, name)
                        if route == "promised" else
                        "backward of `%s` returns None for input `%s`: a "
                        "floating-point tensor that requires grad gets a "
                        "silent zero gradient on the card (the plain "
                        "version's autograd gives the true one) — return "
                        "its gradient, raise when ctx.needs_input_grad[%d] "
                        "asks for it, .detach() it at every apply site, or "
                        "declare <FLAG> = False with <FLAG>_ARGS naming it"
                        % (name, param, i))
                    yield self.finding(mi, ret, msg,
                                       symbol=f"{ci.qualname}.backward")

    @staticmethod
    def _declared(param, pos, caps, sites) -> str:
        flags = caps.get(param, [])
        if any(v is False for _f, v in flags):
            return "ok"
        if any(v is True for _f, v in flags):
            return "promised"
        if not sites:
            return "violation"
        per_site = [_Site(c, pos) for c in sites]
        if all(s.detached() or s.non_tensor() for s in per_site):
            return "ok"
        return "violation"
