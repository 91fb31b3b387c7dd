"""Plain reading of the port's CUDA sources for the kernel-shape rule
(DESIGN.md §10, §15).

No compiler is asked: the ``.cu`` / ``.cuh`` files are tokenized and read
at the level the rule needs, as a reader of the sources would:

  * namespace-scope ``constexpr`` integer constants, keyed by their
    namespace (``single::SLICE`` and ``dense::SLICE`` are two constants;
    anonymous namespaces add no component), template variables
    (``template <bool P> constexpr int UNROLL = P ? 4 : 8;``) included;
  * ``struct`` layouts (member arrays with their natural alignment);
  * every ``__global__`` kernel: its template parameters,
    ``__launch_bounds__`` arguments, local ``constexpr`` values and
    ``__shared__`` declarations (``extern __shared__`` is dynamic);
  * every ``extern "C"`` function and its parameter count;
  * whether the sources build bit masks by shifting (``<<``).

A translation unit is a ``kernel.cu`` with the files it ``#include``s in
quotes, each read once. Integer expressions are evaluated with C
semantics (truncating ``/`` and ``%``, ``?:``); a name that does not
resolve raises ``Unresolved``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

_TOKEN_RE = re.compile(r"""
   (?P<ws>\s+)
  |(?P<comment>//[^\n]*|/\*.*?\*/)
  |(?P<pp>\#(?:\\\n|[^\n])*)
  |(?P<str>"(?:\\.|[^"\\\n])*")
  |(?P<chr>'(?:\\.|[^'\\\n])*')
  |(?P<num>(?:0[xX][0-9a-fA-F]+|\d+(?:\.\d*)?(?:[eE][+-]?\d+)?)[uUlLfF]*)
  |(?P<id>[A-Za-z_]\w*)
  |(?P<op>::|<<=|>>=|<<|>>|<=|>=|==|!=|&&|\|\||->|\+\+|--|[-+*/%&|^]=
     |[{}()\[\];,<>=+\-*/%&|^!~?:.])
""", re.X | re.S)
_INCLUDE_RE = re.compile(r'#\s*include\s*"([^"]+)"')

# byte size (= alignment) of the scalar types shared memory is declared in
SCALAR_BYTES = {
    "bool": 1, "char": 1, "signed char": 1, "unsigned char": 1,
    "int8_t": 1, "uint8_t": 1,
    "short": 2, "unsigned short": 2, "int16_t": 2, "uint16_t": 2,
    "half": 2, "__half": 2, "__nv_bfloat16": 2,
    "int": 4, "unsigned": 4, "unsigned int": 4, "int32_t": 4,
    "uint32_t": 4, "float": 4,
    "long": 8, "unsigned long": 8, "long long": 8, "unsigned long long": 8,
    "int64_t": 8, "uint64_t": 8, "double": 8, "size_t": 8,
    "int2": 8, "uint2": 8, "float2": 8,
    "int4": 16, "uint4": 16, "float4": 16,
}
_QUALIFIERS = ("const", "volatile", "static", "__restrict__")


class Unresolved(Exception):
    """An expression names something the reader cannot evaluate."""


@dataclass(frozen=True)
class Tok:
    kind: str
    text: str
    line: int


@dataclass
class Const:
    """A namespace-scope ``constexpr``; ``tparams`` for a template
    variable."""
    qname: str
    ns: tuple
    expr: list
    tparams: list
    path: Path
    line: int


@dataclass
class Decl:
    """One declarator: ``type name[d0][d1]``, or a pointer."""
    type: str
    name: str
    dims: list          # token lists
    pointer: bool = False
    align: Optional[list] = None   # __align__(N) tokens


@dataclass
class Kernel:
    qname: str
    ns: tuple
    tparams: list
    bounds: list        # __launch_bounds__ argument token lists
    shared: list        # static __shared__ Decls
    dynamic: bool       # declares extern __shared__
    locals: dict        # local constexpr name -> token list
    path: Path
    line: int


@dataclass
class CFunc:
    name: str
    n_params: int
    path: Path
    line: int


@dataclass
class Unit:
    """One translation unit: a ``kernel.cu`` and what it includes."""
    files: list = field(default_factory=list)
    constants: dict = field(default_factory=dict)
    structs: dict = field(default_factory=dict)   # qname -> (ns, [Decl])
    kernels: dict = field(default_factory=dict)
    c_functions: dict = field(default_factory=dict)
    shifts: bool = False

    # -- evaluation ----------------------------------------------------------
    def lookup(self, table: dict, name: str, ns: tuple):
        """Resolve ``name`` (maybe qualified) from namespace ``ns`` outward."""
        for k in range(len(ns), -1, -1):
            key = "::".join(ns[:k] + (name,))
            if key in table:
                return key, table[key]
        return None, None

    def constant(self, qname: str, targs: Optional[list] = None) -> int:
        """Value of constant ``qname``; ``targs`` bind a template
        variable's parameters."""
        c = self.constants.get(qname)
        if c is None:
            raise Unresolved(qname)
        env: dict[str, int] = {}
        if c.tparams:
            if targs is None or len(targs) != len(c.tparams):
                raise Unresolved(f"{qname} needs {len(c.tparams)} "
                                 f"template arguments")
            env = dict(zip([p for _, p in c.tparams], targs))
        return self.evaluate(c.expr, c.ns, env)

    def evaluate(self, toks: list, ns: tuple, env: dict,
                 local: Optional[dict] = None) -> int:
        """Value of the integer expression ``toks`` seen from namespace
        ``ns``; ``env`` holds bound template parameters, ``local`` a
        kernel's local constexpr token lists."""
        local = local or {}

        def name_value(name: str, targs: Optional[list]) -> int:
            if name in env:
                return env[name]
            if name in local:
                return self.evaluate(local[name], ns, env, {
                    k: v for k, v in local.items() if k != name})
            key, _ = self.lookup(self.constants, name, ns)
            if key is None:
                raise Unresolved(name)
            return self.constant(key, targs)

        def is_template_var(name: str) -> bool:
            _, c = self.lookup(self.constants, name, ns)
            return c is not None and bool(c.tparams)

        return _Expr(toks, name_value, is_template_var).parse()

    def type_layout(self, type_name: str, ns: tuple, env: dict,
                    local: Optional[dict] = None) -> tuple[int, int]:
        """(size, alignment) of a scalar or a struct read here."""
        if type_name in SCALAR_BYTES:
            n = SCALAR_BYTES[type_name]
            return n, n
        key, found = self.lookup(self.structs, type_name, ns)
        if key is None:
            raise Unresolved(f"type {type_name}")
        struct_ns, members = found
        return self.layout(members, struct_ns, env, local)

    def layout(self, decls: list, ns: tuple, env: dict,
               local: Optional[dict] = None) -> tuple[int, int]:
        """(bytes, alignment) of ``decls`` laid out in declaration order,
        each at its natural alignment, the total rounded to the largest
        alignment (a struct's layout; a kernel's static shared memory)."""
        off, align = 0, 1
        for d in decls:
            if d.pointer:
                size, a = 8, 8
            else:
                size, a = self.type_layout(d.type, ns, env, local)
            if d.align:
                a = max(a, self.evaluate(d.align, ns, env, local))
            for dim in d.dims:
                size *= self.evaluate(dim, ns, env, local)
            off = -(-off // a) * a + size
            align = max(align, a)
        return -(-off // align) * align, align

    def static_smem(self, kernel: Kernel, env: dict) -> int:
        """Bytes of ``kernel``'s static ``__shared__`` declarations."""
        off = 0
        for d in kernel.shared:
            size, a = self.layout([d], kernel.ns, env, kernel.locals)
            off = -(-off // a) * a + size
        return off

    def launch_bounds(self, kernel: Kernel, env: dict
                      ) -> tuple[Optional[int], Optional[int]]:
        """(max threads, min blocks per SM) of ``__launch_bounds__``."""
        vals = [self.evaluate(b, kernel.ns, env, kernel.locals)
                for b in kernel.bounds[:2]]
        vals += [None] * (2 - len(vals))
        return vals[0], vals[1]


def bind(kernel_or_const_tparams: list, args: str) -> dict:
    """Template parameter binding of an instance key such as
    ``"<true, 4>"``."""
    body = args.strip()
    if not (body.startswith("<") and body.endswith(">")):
        raise Unresolved(f"instance {args!r} is not of the form <a, b>")
    parts = [p.strip() for p in body[1:-1].split(",") if p.strip()]
    names = [p for _, p in kernel_or_const_tparams]
    if len(parts) != len(names):
        raise Unresolved(f"instance {args!r} binds {len(parts)} of "
                         f"{len(names)} template parameters")
    values = []
    for p in parts:
        values.append(_Expr(tokenize(p), _no_names,
                            lambda n: False).parse())
    return dict(zip(names, values))


def _no_names(name, targs):
    raise Unresolved(name)


# ----------------------------------------------------------------------------
# Tokens
# ----------------------------------------------------------------------------
def tokenize(text: str) -> list[Tok]:
    """Tokens of C++ source, comments dropped, ``a::b`` merged into one
    identifier; preprocessor lines are single ``pp`` tokens."""
    raw: list[Tok] = []
    line = 1
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:  # a character C++ allows but the rule never needs
            pos += 1
            continue
        kind = m.lastgroup
        tok = m.group(0)
        if kind not in ("ws", "comment"):
            raw.append(Tok(kind, tok, line))
        line += tok.count("\n")
        pos = m.end()
    out: list[Tok] = []
    i = 0
    while i < len(raw):
        t = raw[i]
        if t.kind == "id":
            text_ = t.text
            while (i + 2 < len(raw) and raw[i + 1].text == "::"
                   and raw[i + 2].kind == "id"):
                text_ += "::" + raw[i + 2].text
                i += 2
            out.append(Tok("id", text_, t.line))
        else:
            out.append(t)
        i += 1
    return out


def _match(toks: list, i: int, open_: str, close: str) -> int:
    """Index of the token closing the group opened at ``toks[i]``."""
    depth = 0
    for j in range(i, len(toks)):
        if toks[j].text == open_:
            depth += 1
        elif toks[j].text == close:
            depth -= 1
            if depth == 0:
                return j
    raise Unresolved(f"unbalanced {open_!r} at line {toks[i].line}")


def _split_top(toks: list, sep: str = ",") -> list[list]:
    parts, cur, depth = [], [], 0
    for t in toks:
        if t.text in "([{":
            depth += 1
        elif t.text in ")]}":
            depth -= 1
        if t.text == sep and depth == 0:
            parts.append(cur)
            cur = []
        else:
            cur.append(t)
    if cur:
        parts.append(cur)
    return parts


def _template_params(toks: list, i: int) -> tuple[list, int]:
    """(``[(kind, name)]``, index after ``>``) of ``template <...>`` whose
    ``<`` is at ``toks[i]``."""
    depth, j = 0, i
    while j < len(toks):
        t = toks[j].text
        if t == "<":
            depth += 1
        elif t == ">":
            depth -= 1
        elif t == ">>":
            depth -= 2
        if depth <= 0 and t in (">", ">>"):
            break
        j += 1
    params = []
    for part in _split_top(toks[i + 1:j]):
        names = [t.text for t in part if t.kind == "id"]
        if len(names) >= 2:
            params.append((names[0], names[1]))
    return params, j + 1


def _type_name(toks: list) -> str:
    words = [t.text for t in toks if t.kind == "id"
             and t.text not in _QUALIFIERS]
    return " ".join(words)


def _declarators(toks: list) -> list[Decl]:
    """Declarators of ``type a[n], b;`` (initializers dropped)."""
    align = None
    body = []
    i = 0
    while i < len(toks):
        if toks[i].text == "__align__" and i + 1 < len(toks):
            end = _match(toks, i + 1, "(", ")")
            align = toks[i + 2:end]
            i = end + 1
            continue
        body.append(toks[i])
        i += 1
    out: list[Decl] = []
    type_toks: list = []
    for n, part in enumerate(_split_top(body)):
        eq = [k for k, t in enumerate(part) if t.text == "="]
        if eq:
            part = part[:eq[0]]
        brk = [k for k, t in enumerate(part) if t.text == "["]
        head = part[:brk[0]] if brk else part
        ids = [k for k, t in enumerate(head) if t.kind == "id"]
        if not ids:
            continue
        name_at = ids[-1]
        if n == 0:
            type_toks = head[:name_at]
        pointer = any(t.text == "*" for t in head[:name_at]) or (
            n == 0 and any(t.text == "*" for t in type_toks))
        dims = []
        k = brk[0] if brk else len(part)
        while k < len(part) and part[k].text == "[":
            end = _match(part, k, "[", "]")
            dims.append(part[k + 1:end])
            k = end + 1
        out.append(Decl(_type_name(type_toks), head[name_at].text, dims,
                        pointer, align))
    return out


# ----------------------------------------------------------------------------
# Reading a translation unit
# ----------------------------------------------------------------------------
def read_unit(kernel_cu: Path) -> Unit:
    """The translation unit of ``kernel_cu``: it and its quoted includes,
    each read once (they are ``#pragma once``)."""
    unit = Unit()
    _read_file(Path(kernel_cu), unit)
    return unit


def _read_file(path: Path, unit: Unit) -> None:
    path = path.resolve()
    if path in unit.files:
        return
    unit.files.append(path)
    toks = tokenize(path.read_text(encoding="utf-8"))
    if any(t.text == "<<" and (k + 1 == len(toks) or toks[k + 1].text != "<")
           for k, t in enumerate(toks)):   # a shift, not a <<<launch>>>
        unit.shifts = True
    ns: list[str] = []
    pending: Optional[list] = None
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.kind == "pp":
            m = _INCLUDE_RE.match(t.text)
            if m:
                inc = path.parent / m.group(1)
                if not inc.is_file():
                    raise Unresolved(f"{path.name}:{t.line} includes "
                                     f"{m.group(1)}, which does not exist")
                _read_file(inc, unit)
            i += 1
            continue
        if t.text == "namespace":
            j = i + 1
            name = ""
            if j < len(toks) and toks[j].kind == "id":
                name = toks[j].text
                j += 1
            if j < len(toks) and toks[j].text == "{":
                ns.append(name)
                i = j + 1
                continue
        if t.text == "}":
            if ns:
                ns.pop()
            i += 1
            continue
        if t.text == "template" and i + 1 < len(toks) \
                and toks[i + 1].text == "<":
            pending, i = _template_params(toks, i + 1)
            continue
        # one declaration or definition: up to ';' or '{' outside parens
        j, depth = i, 0
        while j < len(toks):
            x = toks[j].text
            if x == "(":
                depth += 1
            elif x == ")":
                depth -= 1
            elif depth == 0 and x in (";", "{"):
                break
            j += 1
        stmt = toks[i:j]
        scope = tuple(n for n in ns if n)
        if j >= len(toks):
            break
        if toks[j].text == ";":
            _namespace_decl(stmt, scope, pending, path, unit)
            i = j + 1
        else:
            end = _match(toks, j, "{", "}")
            words = [s.text for s in stmt]
            if "=" in words:                       # brace initializer
                pass
            elif words[:1] in (["struct"], ["class"]) and len(stmt) >= 2:
                qname = "::".join(scope + (stmt[1].text,))
                members = []
                for decl in _split_top(toks[j + 1:end], ";"):
                    if decl and not any(x.text in ("(", "{") for x in decl):
                        members.extend(_declarators(decl))
                if not pending:
                    unit.structs[qname] = (scope, members)
            elif "__global__" in words:
                _kernel(stmt, toks[j + 1:end], scope, pending, path, unit)
            elif words[:2] == ["extern", '"C"']:
                _c_function(stmt, path, unit)
            i = end + 1
            if i < len(toks) and toks[i].text == ";":
                i += 1
        pending = None


def _namespace_decl(stmt: list, scope: tuple, pending, path: Path,
                    unit: Unit) -> None:
    words = [t.text for t in stmt]
    if "constexpr" in words and "=" in words and "(" not in words[
            :words.index("=")]:
        eq = words.index("=")
        name = stmt[eq - 1].text
        qname = "::".join(scope + (name,))
        unit.constants[qname] = Const(qname, scope, stmt[eq + 1:],
                                      list(pending or []), path,
                                      stmt[eq - 1].line)
    elif words[:2] == ["extern", '"C"'] and "(" in words:
        _c_function(stmt, path, unit)


def _c_function(stmt: list, path: Path, unit: Unit) -> None:
    words = [t.text for t in stmt]
    if "(" not in words:
        return
    k = words.index("(")
    end = _match(stmt, k, "(", ")")
    params = _split_top(stmt[k + 1:end])
    n = 0 if not params or [t.text for t in params[0]] == ["void"] \
        else len(params)
    name = stmt[k - 1]
    unit.c_functions[name.text] = CFunc(name.text, n, path, name.line)


_ATTRS = ("__launch_bounds__", "__cluster_dims__", "__maxnreg__",
          "__align__")


def _kernel(head: list, body: list, scope: tuple, pending, path: Path,
            unit: Unit) -> None:
    bounds: list = []
    name_tok = None
    k = 0
    while k < len(head):
        t = head[k]
        if t.kind == "id" and k + 1 < len(head) and head[k + 1].text == "(":
            end = _match(head, k + 1, "(", ")")
            if t.text == "__launch_bounds__":
                bounds = _split_top(head[k + 2:end])
            elif t.text not in _ATTRS:
                name_tok = t
            k = end + 1
            continue
        k += 1
    if name_tok is None:
        return
    shared: list = []
    dynamic = False
    local: dict = {}
    start = 0
    for k, t in enumerate(body):
        if t.text in (";", "{", "}"):
            stmt = body[start:k]
            words = [s.text for s in stmt]
            if "__shared__" in words:
                if "extern" in words:
                    dynamic = True
                else:
                    rest = stmt[words.index("__shared__") + 1:]
                    shared.extend(_declarators(rest))
            elif "constexpr" in words and "=" in words:
                c = words.index("constexpr")
                if c + 1 < len(words) and words[c + 1] != "(":
                    eq = words.index("=")
                    local[stmt[eq - 1].text] = stmt[eq + 1:]
            start = k + 1
    qname = "::".join(scope + (name_tok.text,))
    unit.kernels[qname] = Kernel(qname, scope, list(pending or []), bounds,
                                 shared, dynamic, local, path, name_tok.line)


# ----------------------------------------------------------------------------
# Integer expressions
# ----------------------------------------------------------------------------
_BINARY = {
    "||": 1, "&&": 2, "|": 3, "^": 4, "&": 5, "==": 6, "!=": 6,
    "<": 7, "<=": 7, ">": 7, ">=": 7, "<<": 8, ">>": 8,
    "+": 9, "-": 9, "*": 10, "/": 10, "%": 10,
}


def _cdiv(a: int, b: int) -> int:
    if b == 0:
        raise Unresolved("division by zero")
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _apply(op: str, a: int, b: int) -> int:
    if op == "/":
        return _cdiv(a, b)
    if op == "%":
        return a - b * _cdiv(a, b)
    return {
        "||": lambda: int(bool(a) or bool(b)),
        "&&": lambda: int(bool(a) and bool(b)),
        "|": lambda: a | b, "^": lambda: a ^ b, "&": lambda: a & b,
        "==": lambda: int(a == b), "!=": lambda: int(a != b),
        "<": lambda: int(a < b), "<=": lambda: int(a <= b),
        ">": lambda: int(a > b), ">=": lambda: int(a >= b),
        "<<": lambda: a << b, ">>": lambda: a >> b,
        "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
    }[op]()


class _Expr:
    """Precedence-climbing evaluator of one C integer expression."""

    def __init__(self, toks, name_value, is_template_var):
        self.toks = [t for t in toks if t.text != ";"]
        self.i = 0
        self.name_value = name_value
        self.is_template_var = is_template_var

    def peek(self) -> str:
        return self.toks[self.i].text if self.i < len(self.toks) else ""

    def take(self, want: Optional[str] = None) -> Tok:
        if self.i >= len(self.toks):
            raise Unresolved("expression ends early")
        t = self.toks[self.i]
        if want is not None and t.text != want:
            raise Unresolved(f"expected {want!r}, got {t.text!r}")
        self.i += 1
        return t

    def parse(self) -> int:
        v = self.ternary(False)
        if self.i != len(self.toks):
            raise Unresolved(f"cannot read {self.peek()!r} in an "
                             f"integer expression")
        return v

    def ternary(self, in_targs: bool) -> int:
        cond = self.binary(1, in_targs)
        if self.peek() != "?":
            return cond
        self.take("?")
        a = self.ternary(in_targs)
        self.take(":")
        b = self.ternary(in_targs)
        return a if cond else b

    def binary(self, min_prec: int, in_targs: bool) -> int:
        lhs = self.unary(in_targs)
        while True:
            op = self.peek()
            prec = _BINARY.get(op)
            if prec is None or prec < min_prec or (
                    in_targs and op in (">", ">>")):
                return lhs
            self.take()
            rhs = self.binary(prec + 1, in_targs)
            lhs = _apply(op, lhs, rhs)

    def unary(self, in_targs: bool) -> int:
        op = self.peek()
        if op in ("-", "+", "~", "!"):
            self.take()
            v = self.unary(in_targs)
            return {"-": -v, "+": v, "~": ~v, "!": int(not v)}[op]
        return self.primary(in_targs)

    def primary(self, in_targs: bool) -> int:
        t = self.take()
        if t.text == "(":
            v = self.ternary(False)
            self.take(")")
            return v
        if t.kind == "num":
            body = t.text.rstrip("uUlL")
            if any(c in body for c in ".eE") and not body.lower(
                    ).startswith("0x"):
                raise Unresolved(f"non-integer literal {t.text}")
            return int(body, 16) if body.lower().startswith("0x") else (
                int(body, 8) if len(body) > 1 and body[0] == "0"
                else int(body))
        if t.text in ("true", "false"):
            return int(t.text == "true")
        if t.kind == "id":
            targs = None
            if self.peek() == "<" and self.is_template_var(t.text):
                self.take("<")
                targs = [self.ternary(True)]
                while self.peek() == ",":
                    self.take(",")
                    targs.append(self.ternary(True))
                self.take(">")
            return self.name_value(t.text, targs)
        raise Unresolved(f"cannot read {t.text!r} in an integer expression")
