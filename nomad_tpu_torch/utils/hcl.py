"""Minimal HCL2 reader — tokenizer, block/attribute parser, expressions.

The reference consumes HCL in two places: ACL policy rules
(acl/policy.go:237 ``Parse`` via hashicorp/hcl) and job specifications
(jobspec2/parse.go:19 via hcl/v2 + hclsimple). This module is a compact,
dependency-free reader covering the HCL2 subset those two grammars use:

- blocks with 0..n string labels: ``job "web" { ... }``
- attributes: ``count = 3``
- expressions: strings (with ``${...}`` interpolation), numbers, bools,
  null, heredocs, lists, objects, unary/binary operators, ternaries,
  variable traversals (``var.region``, ``a[0].b``), function calls
- comments: ``#``, ``//``, ``/* ... */``

Parsing yields an AST (`Body` of `Attr`/`Block`); evaluation happens
against an `EvalContext` of variables + functions, so jobspec2-style
two-phase use (collect ``variable`` blocks, then evaluate the rest) works.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class HCLError(Exception):
    """Parse or evaluation failure, annotated with line/col."""

    def __init__(self, msg: str, line: int = 0, col: int = 0):
        super().__init__(f"{msg} (line {line}, col {col})" if line else msg)
        self.line = line
        self.col = col


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<newline>\n)
  | (?P<heredoc><<-?(?P<hd_tag>[A-Za-z_][A-Za-z0-9_]*)\n)
  | (?P<number>-?\d+\.\d+([eE][+-]?\d+)?|-?\d+([eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<string>")
  | (?P<op><=|>=|==|!=|&&|\|\||\.\.\.|[-+*/%<>!?:=.,(){}\[\]])
    """,
    re.VERBOSE | re.DOTALL,
)


@dataclass
class Token:
    kind: str  # number|ident|string|op|newline|heredoc|eof
    value: Any
    line: int
    col: int


def _scan_quoted(src: str, pos: int, line: int) -> tuple[list, int]:
    """Scan a double-quoted string starting after the opening quote.
    Returns (parts, new_pos) where parts alternate literal str and
    ('interp', expr_src) tuples for ${...} segments."""
    parts: list = []
    lit: list[str] = []
    i = pos
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':
            if lit:
                parts.append("".join(lit))
            return parts, i + 1
        if c == "\\":
            if i + 1 >= n:
                raise HCLError("unterminated escape", line)
            esc = src[i + 1]
            lit.append(
                {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}.get(esc, esc)
            )
            i += 2
            continue
        if c == "$" and i + 1 < n and src[i + 1] == "$":
            # HCL2 '$${' escape: literal '${' deferred to runtime
            if i + 2 < n and src[i + 2] == "{":
                lit.append("${")
                i += 3
                depth = 1
                while i < n and depth:
                    if src[i] == "{":
                        depth += 1
                    elif src[i] == "}":
                        depth -= 1
                    lit.append(src[i])
                    i += 1
                continue
            lit.append("$")
            i += 1
            continue
        if c == "$" and i + 1 < n and src[i + 1] == "{":
            if lit:
                parts.append("".join(lit))
                lit = []
            depth = 1
            j = i + 2
            while j < n and depth:
                if src[j] == "{":
                    depth += 1
                elif src[j] == "}":
                    depth -= 1
                j += 1
            if depth:
                raise HCLError("unterminated ${ interpolation", line)
            parts.append(("interp", src[i + 2 : j - 1]))
            i = j
            continue
        if c == "\n":
            raise HCLError("newline in string literal", line)
        lit.append(c)
        i += 1
    raise HCLError("unterminated string", line)


def tokenize(src: str) -> list[Token]:
    tokens: list[Token] = []
    pos = 0
    line = 1
    line_start = 0
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise HCLError(f"unexpected character {src[pos]!r}", line, pos - line_start)
        col = pos - line_start + 1
        if m.lastgroup == "ws":
            pass
        elif m.lastgroup == "comment":
            line += m.group().count("\n")
        elif m.lastgroup == "newline":
            tokens.append(Token("newline", "\n", line, col))
            line += 1
            line_start = m.end()
        elif m.lastgroup == "heredoc":
            tag = m.group("hd_tag")
            indent_mode = m.group().startswith("<<-")
            line += 1
            end_re = re.compile(
                r"^[ \t]*" + re.escape(tag) + r"[ \t]*$", re.MULTILINE
            )
            em = end_re.search(src, m.end())
            if not em:
                raise HCLError(f"unterminated heredoc <<{tag}", line)
            body = src[m.end() : em.start()]
            if indent_mode:
                lines = body.split("\n")
                pad = min(
                    (len(l) - len(l.lstrip()) for l in lines if l.strip()),
                    default=0,
                )
                body = "\n".join(l[pad:] if len(l) >= pad else l for l in lines)
            if body.endswith("\n"):
                body = body[:-1]
            tokens.append(Token("string", [body], line, col))
            line += src[m.end() : em.end()].count("\n")
            pos = em.end()
            line_start = pos
            continue
        elif m.lastgroup == "number":
            text = m.group()
            val = float(text) if ("." in text or "e" in text or "E" in text) else int(text)
            tokens.append(Token("number", val, line, col))
        elif m.lastgroup == "ident":
            tokens.append(Token("ident", m.group(), line, col))
        elif m.lastgroup == "string":
            parts, newpos = _scan_quoted(src, m.end(), line)
            tokens.append(Token("string", parts, line, col))
            pos = newpos
            continue
        else:  # op
            tokens.append(Token("op", m.group(), line, col))
        pos = m.end()
    tokens.append(Token("eof", None, line, pos - line_start + 1))
    return tokens


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Attr:
    name: str
    expr: "Expr"
    line: int


@dataclass
class Block:
    type: str
    labels: list[str]
    body: "Body"
    line: int = 0


@dataclass
class Body:
    attrs: dict[str, Attr] = field(default_factory=dict)
    blocks: list[Block] = field(default_factory=list)

    def blocks_of(self, btype: str) -> list[Block]:
        return [b for b in self.blocks if b.type == btype]

    def first(self, btype: str) -> Optional[Block]:
        for b in self.blocks:
            if b.type == btype:
                return b
        return None


# Expressions are closures: Expr(ctx) -> value
Expr = Callable[["EvalContext"], Any]


class EvalContext:
    """Variable + function scope for expression evaluation."""

    def __init__(
        self,
        variables: Optional[dict[str, Any]] = None,
        functions: Optional[dict[str, Callable]] = None,
    ):
        self.variables = variables or {}
        self.functions = dict(_STD_FUNCTIONS)
        if functions:
            self.functions.update(functions)

    def child(self, extra: dict[str, Any]) -> "EvalContext":
        ctx = EvalContext(dict(self.variables), self.functions)
        ctx.variables.update(extra)
        return ctx


def _std_format(fmt: str, *args: Any) -> str:
    # HCL %v ≈ python str; map the common verbs
    out = []
    i = 0
    ai = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            v = fmt[i + 1]
            if v == "%":
                out.append("%")
            elif v in "vsdfq":
                arg = args[ai]
                ai += 1
                if v == "q":
                    out.append('"%s"' % arg)
                elif v == "d":
                    out.append(str(int(arg)))
                elif v == "f":
                    out.append(str(float(arg)))
                else:
                    out.append(_to_string(arg))
            else:
                out.append(c + v)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _to_string(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return ""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


_STD_FUNCTIONS: dict[str, Callable] = {
    # the jobspec2 function table subset (jobspec2/functions.go)
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "join": lambda sep, xs: sep.join(_to_string(x) for x in xs),
    "split": lambda sep, s: s.split(sep),
    "length": lambda x: len(x),
    "min": lambda *xs: min(xs),
    "max": lambda *xs: max(xs),
    "abs": lambda x: abs(x),
    "ceil": lambda x: -(-int(x) // 1) if x == int(x) else int(x) + (x > 0),
    "floor": lambda x: int(x) if x >= 0 or x == int(x) else int(x) - 1,
    "contains": lambda xs, v: v in xs,
    "coalesce": lambda *xs: next((x for x in xs if x not in (None, "")), None),
    "concat": lambda *xs: [v for x in xs for v in x],
    "keys": lambda m: sorted(m.keys()),
    "values": lambda m: [m[k] for k in sorted(m.keys())],
    "lookup": lambda m, k, default=None: m.get(k, default),
    "merge": lambda *ms: {k: v for m in ms for k, v in m.items()},
    "range": lambda *a: list(range(*[int(x) for x in a])),
    "format": _std_format,
    "trimspace": lambda s: s.strip(),
    "replace": lambda s, a, b: s.replace(a, b),
    "substr": lambda s, off, ln: s[off : off + ln] if ln >= 0 else s[off:],
    "tostring": _to_string,
    "tonumber": lambda v: float(v) if "." in str(v) else int(v),
    "toset": lambda xs: sorted(set(xs)),
    "flatten": lambda xs: [v for x in xs for v in (x if isinstance(x, list) else [x])],
    "distinct": lambda xs: list(dict.fromkeys(xs)),
    "reverse": lambda xs: list(reversed(xs)),
    "sort": lambda xs: sorted(xs),
    "element": lambda xs, i: xs[int(i) % len(xs)],
    "chunklist": lambda xs, size: [
        xs[i : i + int(size)] for i in range(0, len(xs), int(size))
    ],
    "regex": lambda pat, s: (re.search(pat, s) or [""])[0],
}
# try()/can() are NOT in this table: they must see their arguments
# UNevaluated to catch evaluation errors (cty semantics) — special-cased
# in _call.


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers ----------------------------------------------------
    def peek(self, skip_nl: bool = False) -> Token:
        j = self.i
        if skip_nl:
            while self.toks[j].kind == "newline":
                j += 1
        return self.toks[j]

    def next(self, skip_nl: bool = False) -> Token:
        if skip_nl:
            while self.toks[self.i].kind == "newline":
                self.i += 1
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def expect_op(self, op: str, skip_nl: bool = False) -> Token:
        t = self.next(skip_nl=skip_nl)
        if t.kind != "op" or t.value != op:
            raise HCLError(f"expected {op!r}, got {t.value!r}", t.line, t.col)
        return t

    # -- body -------------------------------------------------------------
    def parse_body(self, until: Optional[str] = "}") -> Body:
        body = Body()
        while True:
            t = self.peek(skip_nl=True)
            if t.kind == "eof":
                if until is None:
                    return body
                raise HCLError("unexpected EOF, unclosed block", t.line, t.col)
            if until and t.kind == "op" and t.value == until:
                self.next(skip_nl=True)
                return body
            self.parse_item(body)

    def parse_item(self, body: Body) -> None:
        t = self.next(skip_nl=True)
        if t.kind != "ident" and not (t.kind == "string" and len(t.value) == 1):
            raise HCLError(
                f"expected identifier, got {t.value!r}", t.line, t.col
            )
        name = t.value if t.kind == "ident" else t.value[0]
        nxt = self.peek()
        if nxt.kind == "op" and nxt.value == "=":
            self.next()
            expr = self.parse_expr()
            body.attrs[name] = Attr(name, expr, t.line)
            return
        # block: labels* {
        labels: list[str] = []
        while True:
            nxt = self.peek()
            if nxt.kind == "string":
                parts = nxt.value
                if len(parts) != 1 or not isinstance(parts[0], str):
                    raise HCLError(
                        "block label must be a plain string", nxt.line, nxt.col
                    )
                labels.append(parts[0])
                self.next()
            elif nxt.kind == "ident":
                labels.append(nxt.value)
                self.next()
            elif nxt.kind == "op" and nxt.value == "{":
                self.next()
                inner = self.parse_body("}")
                body.blocks.append(Block(name, labels, inner, t.line))
                return
            else:
                raise HCLError(
                    f"expected block label or '{{', got {nxt.value!r}",
                    nxt.line,
                    nxt.col,
                )

    # -- expressions (precedence climbing) --------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_ternary()

    def parse_ternary(self) -> Expr:
        cond = self.parse_binary(0)
        t = self.peek()
        if t.kind == "op" and t.value == "?":
            self.next()
            a = self.parse_ternary()
            self.expect_op(":", skip_nl=True)
            b = self.parse_ternary()
            return lambda ctx: a(ctx) if cond(ctx) else b(ctx)
        return cond

    _BINOPS: list[dict[str, Callable[[Any, Any], Any]]] = [
        {"||": lambda a, b: a or b},
        {"&&": lambda a, b: a and b},
        {"==": lambda a, b: a == b, "!=": lambda a, b: a != b},
        {
            "<": lambda a, b: a < b,
            ">": lambda a, b: a > b,
            "<=": lambda a, b: a <= b,
            ">=": lambda a, b: a >= b,
        },
        {"+": lambda a, b: a + b, "-": lambda a, b: a - b},
        {
            "*": lambda a, b: a * b,
            "/": lambda a, b: a / b,
            "%": lambda a, b: a % b,
        },
    ]

    def parse_binary(self, level: int) -> Expr:
        if level >= len(self._BINOPS):
            return self.parse_unary()
        lhs = self.parse_binary(level + 1)
        ops = self._BINOPS[level]
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ops:
                self.next()
                rhs = self.parse_binary(level + 1)
                fn = ops[t.value]
                prev = lhs
                lhs = (lambda p, r, f: lambda ctx: f(p(ctx), r(ctx)))(prev, rhs, fn)
            else:
                return lhs

    def parse_unary(self) -> Expr:
        t = self.peek()
        if t.kind == "op" and t.value in ("-", "!"):
            self.next()
            inner = self.parse_unary()
            if t.value == "-":
                return lambda ctx: -inner(ctx)
            return lambda ctx: not inner(ctx)
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        expr = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == ".":
                # traversal: .ident or .number (tuple index)
                self.next()
                nt = self.next()
                if nt.kind == "ident":
                    key = nt.value
                    prev = expr
                    expr = (lambda p, k: lambda ctx: _traverse(p(ctx), k, nt))(
                        prev, key
                    )
                elif nt.kind == "number":
                    prev = expr
                    expr = (lambda p, k: lambda ctx: p(ctx)[int(k)])(prev, nt.value)
                else:
                    raise HCLError("expected attribute name", nt.line, nt.col)
            elif t.kind == "op" and t.value == "[":
                self.next()
                idx = self.parse_expr()
                self.expect_op("]", skip_nl=True)
                prev = expr
                expr = (lambda p, ix: lambda ctx: _index(p(ctx), ix(ctx)))(prev, idx)
            else:
                return expr

    def parse_primary(self) -> Expr:
        t = self.next(skip_nl=True)
        if t.kind == "number":
            v = t.value
            return lambda ctx: v
        if t.kind == "string":
            parts = t.value
            compiled = [
                p if isinstance(p, str) else parse_expression(p[1])
                for p in parts
            ]
            if not compiled:
                return lambda ctx: ""
            if len(compiled) == 1 and isinstance(compiled[0], str):
                s = compiled[0]
                return lambda ctx: s
            return lambda ctx: "".join(
                p if isinstance(p, str) else _to_string(p(ctx)) for p in compiled
            )
        if t.kind == "ident":
            name = t.value
            if name == "true":
                return lambda ctx: True
            if name == "false":
                return lambda ctx: False
            if name == "null":
                return lambda ctx: None
            nxt = self.peek()
            if nxt.kind == "op" and nxt.value == "(":
                self.next()
                args: list[Expr] = []
                spread = False
                while True:
                    pt = self.peek(skip_nl=True)
                    if pt.kind == "op" and pt.value == ")":
                        self.next(skip_nl=True)
                        break
                    args.append(self.parse_expr())
                    pt = self.peek(skip_nl=True)
                    if pt.kind == "op" and pt.value == "...":
                        self.next(skip_nl=True)
                        spread = True
                        pt = self.peek(skip_nl=True)
                    if pt.kind == "op" and pt.value == ",":
                        self.next(skip_nl=True)
                return (
                    lambda ctx, n=name, a=tuple(args), sp=spread: _call(
                        ctx, n, a, sp, t
                    )
                )
            return lambda ctx: _lookup_var(ctx, name, t)
        if t.kind == "op" and t.value == "(":
            inner = self.parse_expr()
            self.expect_op(")", skip_nl=True)
            return inner
        if t.kind == "op" and t.value == "[":
            items: list[Expr] = []
            while True:
                pt = self.peek(skip_nl=True)
                if pt.kind == "op" and pt.value == "]":
                    self.next(skip_nl=True)
                    break
                items.append(self.parse_expr())
                pt = self.peek(skip_nl=True)
                if pt.kind == "op" and pt.value == ",":
                    self.next(skip_nl=True)
            return lambda ctx: [it(ctx) for it in items]
        if t.kind == "op" and t.value == "{":
            pairs: list[tuple[Expr, Expr]] = []
            while True:
                pt = self.peek(skip_nl=True)
                if pt.kind == "op" and pt.value == "}":
                    self.next(skip_nl=True)
                    break
                kt = self.next(skip_nl=True)
                if kt.kind == "ident":
                    kexpr: Expr = lambda ctx, k=kt.value: k
                elif kt.kind == "string":
                    # interpolated keys evaluate like string values
                    compiled_key = [
                        p if isinstance(p, str) else parse_expression(p[1])
                        for p in kt.value
                    ]
                    kexpr = lambda ctx, cp=tuple(compiled_key): "".join(
                        p if isinstance(p, str) else _to_string(p(ctx))
                        for p in cp
                    )
                elif kt.kind == "op" and kt.value == "(":
                    kexpr = self.parse_expr()
                    self.expect_op(")", skip_nl=True)
                else:
                    raise HCLError("expected object key", kt.line, kt.col)
                sep = self.next(skip_nl=True)
                if sep.kind != "op" or sep.value not in ("=", ":"):
                    raise HCLError("expected '=' or ':'", sep.line, sep.col)
                vexpr = self.parse_expr()
                pairs.append((kexpr, vexpr))
                pt = self.peek(skip_nl=True)
                if pt.kind == "op" and pt.value == ",":
                    self.next(skip_nl=True)
            return lambda ctx: {k(ctx): v(ctx) for k, v in pairs}
        raise HCLError(f"unexpected token {t.value!r}", t.line, t.col)


def _traverse(obj: Any, key: str, tok: Token) -> Any:
    if isinstance(obj, dict):
        if key not in obj:
            raise HCLError(f"unknown attribute {key!r}", tok.line, tok.col)
        return obj[key]
    if hasattr(obj, key):
        return getattr(obj, key)
    raise HCLError(f"cannot traverse into {type(obj).__name__}", tok.line, tok.col)


def _index(obj: Any, idx: Any) -> Any:
    if isinstance(obj, dict):
        return obj[idx]
    return obj[int(idx)]


def _call(ctx: EvalContext, name: str, args: tuple, spread: bool, tok: Token) -> Any:
    if name == "try":
        # first argument that evaluates without error
        for a in args:
            try:
                return a(ctx)
            except (HCLError, IndexError, KeyError, TypeError):
                continue
        raise HCLError("try(): no argument evaluated successfully", tok.line, tok.col)
    if name == "can":
        try:
            args[0](ctx) if args else None
            return True
        except (HCLError, IndexError, KeyError, TypeError):
            return False
    fn = ctx.functions.get(name)
    if fn is None:
        raise HCLError(f"unknown function {name!r}", tok.line, tok.col)
    vals = [a(ctx) for a in args]
    if spread and vals:
        last = vals.pop()
        vals.extend(last)
    return fn(*vals)


def _lookup_var(ctx: EvalContext, name: str, tok: Token) -> Any:
    if name in ctx.variables:
        return ctx.variables[name]
    raise HCLError(f"unknown variable {name!r}", tok.line, tok.col)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def parse(src: str) -> Body:
    """Parse an HCL document into a Body AST."""
    p = _Parser(tokenize(src))
    return p.parse_body(until=None)


def parse_expression(src: str) -> Expr:
    """Parse a standalone expression (used for ${...} interpolations)."""
    p = _Parser(tokenize(src))
    expr = p.parse_expr()
    t = p.peek(skip_nl=True)
    if t.kind != "eof":
        raise HCLError(f"trailing tokens after expression: {t.value!r}", t.line, t.col)
    return expr


def evaluate(expr: Expr, ctx: Optional[EvalContext] = None) -> Any:
    return expr(ctx or EvalContext())


def body_to_value(body: Body, ctx: Optional[EvalContext] = None) -> dict:
    """Evaluate a Body into plain dicts: attrs become keys; blocks become
    ``{type: [ {labels..., body...} ]}`` lists. Handy for tests/tools."""
    ctx = ctx or EvalContext()
    out: dict[str, Any] = {name: a.expr(ctx) for name, a in body.attrs.items()}
    for b in body.blocks:
        entry: dict[str, Any] = body_to_value(b.body, ctx)
        for lbl in reversed(b.labels):
            entry = {lbl: entry}
        out.setdefault(b.type, []).append(entry)
    return out
