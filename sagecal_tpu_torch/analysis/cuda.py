"""A small reader of the port's CUDA kernel sources for the lint rules
(counterpart of ``sagecal_tpu/analysis/pallas.py``, which finds the
Pallas kernel bodies and the operands that feed them).

:func:`parse_cuda` reads one ``.cu``/``.cuh`` file with comments and
string literals blanked (offsets kept, so every position maps to its
line) and finds:

- its ``__global__`` functions (templated or not, with or without
  ``__launch_bounds__``) and each one's brace-matched body;
- each kernel's loads and stores: a subscript of one of its pointer
  parameters read as a value, or written (``p[i] = ...``);
- its atomic calls (``atomicAdd`` and kin, and inline-PTX ``red``/
  ``atom`` adds), each with the element type of its target where the
  source declares it;
- its narrow floating-point types (``__nv_bfloat16``, ``__half`` and the
  template parameters the file instantiates with one) and the reads of
  such values that enter arithmetic without a conversion to f32.

JL014 holds the port's kernel numerics contract with it; ``chip_smoke.py``
checks that it finds every ``__global__`` the budget model
(``kernelmodel.py``) reads.  Regular expressions over the blanked text,
no compiler: the reader knows the idioms of ``csrc/`` and says so where
it cannot tell (an atomic whose target type it cannot find counts as a
float one).  Stdlib only.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple

NARROW_TYPES = frozenset({
    "__nv_bfloat16", "nv_bfloat16", "__half", "half",
    "__nv_bfloat162", "nv_bfloat162", "__half2", "half2",
})
FLOAT_TYPES = frozenset({
    "float", "double", "float2", "float4", "double2",
}) | NARROW_TYPES
INT_TYPES = frozenset({
    "int", "unsigned", "long", "short", "char", "size_t", "int32_t",
    "uint32_t", "int64_t", "uint64_t", "unsigned int", "long long",
    "unsigned long long",
})
# conversions of a narrow value to f32
CONVERTERS = frozenset({
    "__bfloat162float", "__half2float", "__low2float", "__high2float",
    "__bfloat1622float2", "__half22float2", "float", "double",
})
# arithmetic in the narrow type itself
NARROW_ARITH = frozenset({
    "__hadd", "__hsub", "__hmul", "__hdiv", "__hfma", "__hneg",
    "__hadd2", "__hsub2", "__hmul2", "__h2div", "__hfma2", "__hneg2",
    "__hadd_sat", "__hmul_sat", "__hfma_sat", "hadd", "hmul", "hfma",
})
ATOMIC_CALLS = ("atomicAdd", "atomicAdd_block", "atomicAdd_system",
                "unsafeAtomicAdd", "atomicSub")

_COMMENT_RE = re.compile(
    r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\\n])*\"|'(?:\\.|[^'\\\n])*'",
    re.S)
_GLOBAL_RE = re.compile(r"__global__\b")
_NAME_PAREN_RE = re.compile(r"(\w+)\s*\(")
_TEMPLATE_RE = re.compile(r"template\s*<([^<>]*)>")
_TYPENAME_RE = re.compile(r"\b(?:typename|class)\s+(\w+)")
_ATOMIC_RE = re.compile(r"\b(" + "|".join(ATOMIC_CALLS) + r")\s*\(")
_PTX_ATOMIC_RE = re.compile(
    r"\b(?:red|atom)(?:\.\w+)*\.add(?:\.noftz)?\.(f16x2|bf16x2|f16|bf16|f32|"
    r"f64)\b")


def blank(text: str) -> str:
    """Comments and string/char literals replaced by spaces (newlines
    kept): every offset of the result is the same line and column of the
    source.  Strings matter to PTX: inline ``asm`` keeps its text."""
    def sub(m):
        s = m.group(0)
        if s[0] in "\"'" and re.search(r"\b(?:red|atom)\.", s):
            return s
        return re.sub(r"[^\n]", " ", s)
    return _COMMENT_RE.sub(sub, text)


def match_close(code: str, i: int) -> int:
    """Index just past the bracket that closes the one at ``i``."""
    pairs = {"(": ")", "[": "]", "{": "}", "<": ">"}
    open_c = code[i]
    close_c = pairs[open_c]
    depth = 0
    for j in range(i, len(code)):
        c = code[j]
        if c == open_c:
            depth += 1
        elif c == close_c:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(code)


def split_args(s: str) -> List[str]:
    """Top-level comma split of an argument list's text."""
    out, depth, cur = [], 0, []
    for c in s:
        if c in "([{<":
            depth += 1
        elif c in ")]}>":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


@dataclasses.dataclass
class Access:
    """One load, store or narrow read: ``name`` at ``pos``."""
    name: str
    pos: int
    line: int
    col: int
    text: str


@dataclasses.dataclass
class Atomic:
    call: str  # atomicAdd, ..., or the PTX mnemonic's type suffix
    pos: int
    line: int
    col: int
    target: str  # the target expression's text
    elem_type: Optional[str]  # declared element type, None when unknown

    @property
    def is_float(self) -> bool:
        if self.call.startswith("ptx."):
            return True
        return self.elem_type is None or self.elem_type in FLOAT_TYPES


@dataclasses.dataclass
class Kernel:
    name: str
    pos: int
    line: int
    params: List[Tuple[str, str, bool]]  # (type, name, is_pointer)
    body_start: int
    body_end: int


@dataclasses.dataclass
class CudaSource:
    path: str
    text: str
    code: str
    lines: List[str]
    kernels: Dict[str, Kernel]
    narrow: Set[str]  # narrow type names, template parameters included
    decls: Dict[str, Tuple[str, bool]]  # name -> (type, is_pointer)
    converters: Set[str]
    pragmas: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)
    file_pragmas: Set[str] = dataclasses.field(default_factory=set)

    def line_col(self, pos: int) -> Tuple[int, int]:
        line = self.code.count("\n", 0, pos) + 1
        return line, pos - (self.code.rfind("\n", 0, pos) + 1)

    def _access(self, name: str, pos: int, end: int) -> Access:
        line, col = self.line_col(pos)
        return Access(name, pos, line, col, self.code[pos:end])

    # ------------------------------------------------- loads and stores
    def accesses(self, kernel: Kernel) -> Tuple[List[Access], List[Access]]:
        """(loads, stores) of the kernel's pointer parameters in its
        body: ``p[i]`` read as a value, or assigned."""
        loads: List[Access] = []
        stores: List[Access] = []
        body = self.code[kernel.body_start:kernel.body_end]
        for _typ, name, is_ptr in kernel.params:
            if not is_ptr:
                continue
            for m in re.finditer(r"\b%s\s*\[" % re.escape(name), body):
                start = kernel.body_start + m.start()
                end = match_close(self.code, kernel.body_start + m.end() - 1)
                if self.code[start - 1:start] == "&":
                    continue  # an address, not a value
                acc = self._access(name, start, end)
                after = self.code[end:end + 2]
                if after[:1] == "=" and after != "==" or re.match(
                        r"\s*[-+*/|&^]?=(?!=)", self.code[end:end + 4]):
                    stores.append(acc)
                else:
                    loads.append(acc)
        return loads, stores

    # ---------------------------------------------------------- atomics
    def atomics(self) -> List[Atomic]:
        out: List[Atomic] = []
        for m in _ATOMIC_RE.finditer(self.code):
            paren = m.end() - 1
            args = split_args(self.code[paren + 1:match_close(
                self.code, paren) - 1])
            target = args[0].strip() if args else ""
            line, col = self.line_col(m.start())
            out.append(Atomic(m.group(1), m.start(), line, col, target,
                              self.target_type(target)))
        for m in _PTX_ATOMIC_RE.finditer(self.code):
            line, col = self.line_col(m.start())
            out.append(Atomic("ptx." + m.group(1), m.start(), line, col,
                              m.group(0), m.group(1)))
        return out

    def target_type(self, target: str) -> Optional[str]:
        """Element type of an atomic's target (``&s[i]``, ``out + k``,
        ``(float*)p``, ``&t.partial[i]``): the cast's type, else the
        declared type of the target's base name."""
        cast = re.match(r"\(\s*(?:const\s+)?(\w[\w ]*?)\s*\*\s*\)", target)
        if cast:
            return self._resolve(cast.group(1).strip())
        expr = target.lstrip("&( ")
        m = re.match(r"[\w.>\-]+", expr)
        if not m:
            return None
        base = re.split(r"\.|->", m.group(0))[-1]
        decl = self.decls.get(base)
        return self._resolve(decl[0]) if decl else None

    def _resolve(self, typ: str) -> str:
        return "__nv_bfloat16" if typ in self.narrow - NARROW_TYPES \
            else typ

    # --------------------------------------------------- narrow values
    def narrow_reads(self) -> List[Access]:
        """Reads of a narrow value (``p[i]``, ``*p`` of a narrow pointer,
        a narrow scalar) that are an operand of ``+ - * / %`` and not
        inside a conversion call, plus every narrow-arithmetic intrinsic
        (``__hmul``...)."""
        out: List[Access] = []
        for name, (typ, is_ptr) in self.decls.items():
            if typ not in self.narrow:
                continue
            if is_ptr:
                pats = [r"\b%s\s*\[" % re.escape(name),
                        r"(?<![\w)\]\s])\s*\*\s*%s\b" % re.escape(name)]
            else:
                pats = [r"(?<![\w.>])%s\b(?!\s*[\[(])" % re.escape(name)]
            for pat in pats:
                for m in re.finditer(pat, self.code):
                    start = m.start()
                    while self.code[start].isspace():
                        start += 1
                    end = (match_close(self.code, m.end() - 1)
                           if self.code[m.end() - 1] == "[" else m.end())
                    if self._is_declaration(start, typ):
                        continue
                    if self._in_converter(start):
                        continue
                    if self._arith_operand(start, end):
                        out.append(self._access(name, start, end))
        for m in _NAME_PAREN_RE.finditer(self.code):
            if m.group(1) in NARROW_ARITH:
                out.append(self._access(m.group(1), m.start(), m.end()))
        return sorted(out, key=lambda a: a.pos)

    def _is_declaration(self, start: int, typ: str) -> bool:
        before = self.code[max(0, start - 80):start]
        return re.search(r"\b%s\s*[*&]?\s*(?:const\s+)?(?:__restrict__\s+)?$"
                         % re.escape(typ), before) is not None

    def _in_converter(self, start: int) -> bool:
        depth = 0
        for j in range(start - 1, max(-1, start - 400), -1):
            c = self.code[j]
            if c in ")]":
                depth += 1
            elif c in "([":
                if depth == 0:
                    if c == "[":
                        return False
                    head = self.code[max(0, j - 60):j].rstrip()
                    if re.search(r"static_cast\s*<\s*(?:float|double)\s*>$",
                                 head):
                        return True
                    m = re.search(r"(\w+)$", head)
                    return bool(m) and m.group(1) in self.converters
                depth -= 1
            elif c in ";{}" and depth == 0:
                return False
        return False

    def _arith_operand(self, start: int, end: int) -> bool:
        before = self.code[:start].rstrip()
        after = self.code[end:].lstrip()
        prev = before[-1:] if before else ""
        prev2 = before[-2:]
        if prev in "+-*/%" and prev2 not in ("++", "--", "->") \
                and not re.search(r"\(\s*\w[\w\s]*\*$", before):
            return True
        if after[:1] in "+-*/%" and after[:2] not in ("++", "--", "->") \
                and after[:2] not in ("//", "/*"):
            return True
        return False


def _params(sig: str, narrow: Set[str]) -> List[Tuple[str, str, bool]]:
    out = []
    for p in split_args(sig):
        p = re.sub(r"\b(const|__restrict__|volatile)\b", " ", p).strip()
        m = re.match(r"(.*?)([*&\s]+)(\w+)\s*(?:=.*)?$", p, re.S)
        if not m:
            continue
        typ = m.group(1).strip()
        out.append((typ, m.group(3), "*" in m.group(2)))
    return out


def parse_cuda(path: str) -> CudaSource:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    code = blank(text)
    # narrow types: the built-in ones, and the template parameters used
    # as pointee types when the file instantiates a template with one
    narrow = set(NARROW_TYPES)
    instantiates = re.search(
        r"<\s*(?:const\s+)?(?:%s)\b" % "|".join(sorted(NARROW_TYPES)), code)
    if instantiates:
        for t in _TEMPLATE_RE.finditer(code):
            for name in _TYPENAME_RE.findall(t.group(1)):
                if re.search(r"\b%s\s*\*" % re.escape(name), code):
                    narrow.add(name)
    typ_alt = "|".join(sorted(FLOAT_TYPES | narrow | INT_TYPES, key=len,
                              reverse=True))
    decls: Dict[str, Tuple[str, bool]] = {}
    decl_re = re.compile(
        r"\b(%s)\b\s*(\*?)\s*(?:const\s+)?(?:__restrict__\s+)?(\w+)\s*"
        r"(?=[,;)=\[])" % typ_alt)
    for m in decl_re.finditer(code):
        name = m.group(3)
        if name in ("const", "__restrict__"):
            continue
        is_ptr = bool(m.group(2)) or code[m.end():m.end() + 1] == "["
        # a narrow declaration wins over a wider one of the same name
        if name not in decls or m.group(1) in narrow:
            decls[name] = (m.group(1), is_ptr)
    converters = set(CONVERTERS)
    narrow_alt = "|".join(sorted(narrow))
    for m in re.finditer(r"\bfloat2?\s+(\w+)\s*\(([^)]*)\)", code):
        if re.search(r"\b(?:%s)\b" % narrow_alt, m.group(2)):
            converters.add(m.group(1))
    kernels: Dict[str, Kernel] = {}
    for g in _GLOBAL_RE.finditer(code):
        m = _NAME_PAREN_RE.search(code, g.end())
        while m and m.group(1) == "__launch_bounds__":
            m = _NAME_PAREN_RE.search(code, match_close(code, m.end() - 1))
        if not m:
            continue
        close = match_close(code, m.end() - 1)
        brace = code.find("{", close)
        if brace < 0 or ";" in code[close:brace]:
            continue  # a declaration
        line = code.count("\n", 0, m.start()) + 1
        kernels[m.group(1)] = Kernel(
            m.group(1), m.start(), line,
            _params(code[m.end():close - 1], narrow), brace,
            match_close(code, brace))
    return CudaSource(path=path, text=text, code=code,
                      lines=text.splitlines(), kernels=kernels,
                      narrow=narrow, decls=decls, converters=converters)


def global_names(path: str) -> List[str]:
    """Names of the ``__global__`` functions a source defines."""
    return sorted(parse_cuda(path).kernels)
