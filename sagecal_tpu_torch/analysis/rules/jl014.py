"""JL014: the port's kernel numerics contract (counterpart of the
reference's precision flow in Pallas kernel bodies).

The port's kernels promise sums in a fixed order and arithmetic in f32:
a repeat is bit-identical, and the card agrees with the plain version to
the stated tolerance.  Four silent ways to break that:

- **float atomics** in ``csrc/*.cu`` (``atomicAdd`` on a ``float``,
  ``double``, ``__half`` or ``__nv_bfloat16`` target, shared memory
  included, or an inline-PTX ``red``/``atom`` float add): the order of
  the additions then follows the scheduler, and two runs differ in the
  last bits.  The kernels sum per block in a fixed tree, then add the
  partials in a second launch;
- **narrow arithmetic** in ``csrc/*.cu``: a bf16 or half value (a
  ``__nv_bfloat16``/``__half`` operand, or a template parameter the file
  instantiates with one) that is an operand of ``+ - * / %`` without a
  conversion to f32 (``__bfloat162float``, ``static_cast<float>``, a
  file-local ``float f(__nv_bfloat16)`` such as ``ld``/``to_f``), or a
  ``__hmul``-style intrinsic.  bf16 values are upcast when loaded;
- **TF32** switched on in Python (``allow_tf32 = True``,
  ``set_float32_matmul_precision("high"/"medium")``, an
  ``fp32_precision = "tf32"``): cuBLAS then multiplies f32 with a
  10-bit mantissa.  ``utils/precision.py``'s scoped switch-off (which
  restores the caller's setting) is the one place that may write it
  from a variable;
- **atomic accumulation** in device-reachable Python:
  ``index_add_``/``index_add``, ``scatter_add_``/``scatter_add``,
  ``index_put_``/``put_`` with ``accumulate=True``, a ``sum``/``mean``/
  ``prod`` ``scatter_reduce``, ``bincount`` with ``weights``.  On CUDA
  these add with float atomics: the port's first fault (its ``res_1``
  moved by up to 2.56e-2 between runs) came from one.  Fixed-order sums
  go through ``core/segment.py``'s plans.

Scope: every ``.cu``/``.cuh`` file analysed; TF32 in every module;
atomic accumulation in device-reachable code.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from sagecal_tpu_torch.analysis.callgraph import qual_of
from sagecal_tpu_torch.analysis.engine import Finding, Rule, path_segments

_TF32_ATTRS = ("allow_tf32",)
_TF32_SETTERS = {"torch.set_float32_matmul_precision"}
_SCOPED_SWITCH = ("utils", "precision.py")
_ACCUM_ALWAYS = {"index_add_", "index_add", "scatter_add_", "scatter_add"}
_ACCUM_KW = {"index_put_", "index_put", "put_", "put"}
_REDUCE = {"scatter_reduce_", "scatter_reduce"}


class _CudaSite:
    """A ``.cu`` position as a node for :meth:`Rule.finding`."""

    def __init__(self, line: int, col: int):
        self.lineno, self.col_offset = line, col


class KernelNumerics(Rule):
    id = "JL014"
    title = ("kernel numerics contract: no float atomics or narrow "
             "arithmetic in csrc, no TF32, no atomic accumulation")

    def check(self, graph) -> Iterator[Finding]:
        for src in graph.cuda.values():
            yield from self._check_cuda(src)
        for mi in graph.modules.values():
            if mi.tree is not None:
                yield from self._check_python(graph, mi)

    # ---------------------------------------------------------- CUDA
    def _check_cuda(self, src) -> Iterator[Finding]:
        for a in src.atomics():
            if not a.is_float:
                continue
            what = (f"a `{a.elem_type}` target" if a.elem_type
                    else "a target whose type the reader cannot find")
            yield self.finding(
                src, _CudaSite(a.line, a.col),
                f"float atomic `{a.call}` on {what} (`{a.target}`): the "
                f"order of the additions follows the scheduler, so a "
                f"repeat is not bit-identical — sum in a fixed order "
                f"(per-block tree, then the partials in order)",
                symbol=self._kernel_of(src, a.pos))
        for r in src.narrow_reads():
            yield self.finding(
                src, _CudaSite(r.line, r.col),
                f"narrow (bf16/half) value `{r.text.strip()}` used in "
                f"arithmetic without conversion to f32 — upcast at the "
                f"load (__bfloat162float, or the file's ld/to_f)",
                symbol=self._kernel_of(src, r.pos))

    @staticmethod
    def _kernel_of(src, pos: int) -> str:
        for k in src.kernels.values():
            if k.body_start <= pos < k.body_end:
                return k.name
        return ""

    # -------------------------------------------------------- Python
    def _check_python(self, graph, mi) -> Iterator[Finding]:
        scoped = (_SCOPED_SWITCH[0] in path_segments(mi.path)
                  and os.path.basename(mi.path) == _SCOPED_SWITCH[1])
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Assign):
                msg = self._tf32_assign(node, scoped)
                if msg:
                    fi = mi.enclosing_function(node)
                    yield self.finding(mi, node, msg,
                                       symbol=fi.qualname if fi else "")
            elif isinstance(node, ast.Call):
                msg = self._tf32_call(node, mi)
                if msg is None:
                    msg = self._accumulate(node, mi)
                    if msg is None:
                        continue
                    fi = graph.stmt_reachable(mi, node)
                    if fi is None:
                        continue
                else:
                    fi = mi.enclosing_function(node)
                yield self.finding(mi, node, msg,
                                   symbol=fi.qualname if fi else "")

    @staticmethod
    def _tf32_assign(node: ast.Assign, scoped: bool):
        for t in node.targets:
            if not isinstance(t, ast.Attribute):
                continue
            v = node.value
            if t.attr in _TF32_ATTRS:
                if isinstance(v, ast.Constant):
                    if v.value is True:
                        return ("TF32 switched on (`allow_tf32 = True`): "
                                "f32 matmuls lose 13 mantissa bits")
                    continue
                if not scoped:
                    return ("`allow_tf32` written from a value outside "
                            "utils/precision.py's scoped switch-off: TF32 "
                            "may be on")
            elif t.attr == "fp32_precision":
                if isinstance(v, ast.Constant) and v.value == "tf32":
                    return ("TF32 switched on (`fp32_precision = "
                            "\"tf32\"`): f32 matmuls lose 13 mantissa bits")
        return None

    @staticmethod
    def _tf32_call(node: ast.Call, mi):
        q = qual_of(node.func, mi.imports, mi.toplevel, mi.name)
        if q in _TF32_SETTERS and node.args:
            a = node.args[0]
            if not (isinstance(a, ast.Constant) and a.value == "highest"):
                return ("`set_float32_matmul_precision` other than "
                        "\"highest\" lets cuBLAS use TF32")
        return None

    @staticmethod
    def _accumulate(node: ast.Call, mi):
        f = node.func
        if not isinstance(f, ast.Attribute):
            return None
        head = f.value
        while isinstance(head, ast.Attribute):
            head = head.value
        module = mi.imports.get(head.id) if isinstance(head, ast.Name) \
            else None
        if module is not None and module != "torch":
            return None  # numpy and the like: host arrays, no atomics
        name = f.attr
        atomic = False
        if name in _ACCUM_ALWAYS:
            atomic = True
        elif name in _ACCUM_KW:
            atomic = any(k.arg == "accumulate" and not (
                isinstance(k.value, ast.Constant) and not k.value.value)
                for k in node.keywords)
        elif name in _REDUCE:
            red = [k.value for k in node.keywords if k.arg == "reduce"]
            red += node.args[3:4]
            atomic = any(isinstance(r, ast.Constant)
                         and r.value in ("sum", "mean", "prod")
                         for r in red)
        elif name == "bincount":
            atomic = any(k.arg == "weights" for k in node.keywords) or \
                len(node.args) > (1 if module == "torch" else 0)
        if not atomic:
            return None
        return (f"`{name}` accumulates with float atomics on CUDA: the "
                f"sum's order follows the scheduler and a repeat is not "
                f"bit-identical — use core/segment.py's fixed-order plans")
