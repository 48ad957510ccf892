"""Symbolic PDE/BC compiler on tensors: equation strings → residual functions.

Port of ``tpinn.core.pde``: the same grammar, tokenizer, recursive-descent
parser and AST, so an equation string yields the same derivative
multi-indices, ``max_order``, ``is_linear`` and syntax errors in both
packages.  Evaluation walks the AST on ``torch`` tensors; the u-partials
come from the generic ``torch.func.jvp`` engine (``residual``) or from the
structure-aware dispatcher (``residual_fast``, tpinn_torch.core.taylor),
which sends plain dense nets to kernel B1.

``compile_system`` (coupled multi-field systems) is not ported yet
(ROADMAP.md Queue A item 13).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from tpinn_torch.core import deriv

Tensor = torch.Tensor
MultiIndex = Tuple[int, ...]

_FUNCTIONS: Dict[str, Callable[[Tensor], Tensor]] = {
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "tanh": torch.tanh,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "abs": torch.abs,
}

_CONSTANTS = {"pi": math.pi, "e": math.e}


class PDESyntaxError(ValueError):
    """Raised when an equation string does not parse."""


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<NUMBER>\d+(?:\.\d*)?|\.\d+)
  | (?P<IDENT>[a-zA-Z][a-zA-Z0-9_]*)
  | (?P<POW>\*\*)
  | (?P<OP>[+\-*/])
  | (?P<LPAREN>\()
  | (?P<RPAREN>\))
  | (?P<EQUALS>=)
  | (?P<WS>\s+)
""",
    re.VERBOSE,
)


@dataclass(frozen=True)
class Token:
    kind: str
    text: str
    pos: int


def tokenize(s: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            raise PDESyntaxError(f"unexpected character {s[pos]!r} at position {pos}")
        kind = m.lastgroup
        if kind != "WS":
            tokens.append(Token(kind, m.group(), pos))
        pos = m.end()
    return tokens


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class Num(Node):
    value: float


@dataclass(frozen=True)
class Const(Node):
    name: str


@dataclass(frozen=True)
class Coord(Node):
    index: int
    name: str


@dataclass(frozen=True)
class Param(Node):
    """A named unknown coefficient, evaluated from the ``coef`` dict passed
    at residual time."""

    name: str


@dataclass(frozen=True)
class UDeriv(Node):
    """Value (empty index) or partial derivative of a solution field;
    ``field`` is the component column (0 for scalar problems)."""

    index: MultiIndex
    field: int = 0


@dataclass(frozen=True)
class Unary(Node):
    op: str
    operand: Node


@dataclass(frozen=True)
class BinOp(Node):
    op: str
    left: Node
    right: Node


@dataclass(frozen=True)
class Call(Node):
    fn: str
    arg: Node


class _Parser:
    """Recursive descent: expr > term > unary > power > atom."""

    def __init__(
        self,
        tokens: List[Token],
        coords: Sequence[str],
        params: Sequence[str] = (),
        fields: Sequence[str] = ("u",),
    ):
        self.tokens = tokens
        self.i = 0
        self.coords = list(coords)
        self.coord_index = {c: k for k, c in enumerate(coords)}
        self.fields = list(fields)
        self.field_index = {f: k for k, f in enumerate(fields)}
        self.params = set(params)
        reserved = set(coords) | set(_FUNCTIONS) | set(_CONSTANTS)
        bad = self.params & (reserved | set(fields))
        if bad:
            raise PDESyntaxError(
                f"parameter names {sorted(bad)} collide with coordinates/"
                f"functions/constants/fields"
            )
        bad_f = set(fields) & reserved
        if bad_f:
            raise PDESyntaxError(
                f"field names {sorted(bad_f)} collide with coordinates/"
                f"functions/constants"
            )

    def peek(self) -> Optional[Token]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> Token:
        tok = self.peek()
        if tok is None:
            raise PDESyntaxError("unexpected end of expression")
        self.i += 1
        return tok

    def expect(self, kind: str) -> Token:
        tok = self.next()
        if tok.kind != kind:
            raise PDESyntaxError(
                f"expected {kind} at position {tok.pos}, got {tok.text!r}"
            )
        return tok

    def parse_expr(self) -> Node:
        node = self.parse_term()
        while (tok := self.peek()) is not None and tok.text in "+-":
            self.next()
            node = BinOp(tok.text, node, self.parse_term())
        return node

    def parse_term(self) -> Node:
        node = self.parse_unary()
        while (tok := self.peek()) is not None and tok.text in "*/" and tok.kind == "OP":
            self.next()
            node = BinOp(tok.text, node, self.parse_unary())
        return node

    def parse_unary(self) -> Node:
        tok = self.peek()
        if tok is not None and tok.text == "-" and tok.kind == "OP":
            self.next()
            return Unary("-", self.parse_unary())
        if tok is not None and tok.text == "+" and tok.kind == "OP":
            self.next()
            return self.parse_unary()
        return self.parse_power()

    def parse_power(self) -> Node:
        base = self.parse_atom()
        tok = self.peek()
        if tok is not None and tok.kind == "POW":
            self.next()
            # right-associative; exponent may be unary-negated
            return BinOp("**", base, self.parse_unary())
        return base

    def parse_atom(self) -> Node:
        tok = self.next()
        if tok.kind == "NUMBER":
            return Num(float(tok.text))
        if tok.kind == "LPAREN":
            node = self.parse_expr()
            self.expect("RPAREN")
            return node
        if tok.kind == "IDENT":
            return self._resolve_ident(tok)
        raise PDESyntaxError(f"unexpected token {tok.text!r} at position {tok.pos}")

    def _resolve_ident(self, tok: Token) -> Node:
        name = tok.text
        if name in _FUNCTIONS:
            self.expect("LPAREN")
            arg = self.parse_expr()
            self.expect("RPAREN")
            return Call(name, arg)
        if name in _CONSTANTS and name not in self.coord_index:
            return Const(name)
        if name in self.field_index:
            return UDeriv((), self.field_index[name])
        if "_" in name:
            head, _, suffix = name.partition("_")
            if head in self.field_index and suffix:
                idx: List[int] = []
                for ch in suffix:
                    if ch not in self.coord_index:
                        raise PDESyntaxError(
                            f"derivative suffix {ch!r} in {name!r} is not one "
                            f"of the coordinates {self.coords}"
                        )
                    idx.append(self.coord_index[ch])
                return UDeriv(tuple(sorted(idx)), self.field_index[head])
        if name in self.coord_index:
            return Coord(self.coord_index[name], name)
        if name in self.params:
            return Param(name)
        raise PDESyntaxError(
            f"unknown identifier {name!r} at position {tok.pos}; coordinates are "
            f"{self.coords}"
        )


def parse(
    expr: str,
    coords: Sequence[str],
    params: Sequence[str] = (),
    fields: Sequence[str] = ("u",),
) -> Node:
    """Parse an expression (or ``lhs = rhs``) into an AST."""
    s = expr.strip()
    if not s:
        raise PDESyntaxError("empty expression")
    if "=" in s:
        parts = s.split("=")
        if len(parts) != 2:
            raise PDESyntaxError("more than one '=' in equation")
        lhs, rhs = parts
        return BinOp("-", parse(lhs, coords, params, fields),
                     parse(rhs, coords, params, fields))
    tokens = tokenize(s)
    p = _Parser(tokens, coords, params, fields)
    node = p.parse_expr()
    if p.peek() is not None:
        tok = p.peek()
        raise PDESyntaxError(f"trailing input {tok.text!r} at position {tok.pos}")
    return node


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def depends_on_u(node: Node) -> bool:
    """Whether any u-term (value or derivative) appears under ``node``."""
    if isinstance(node, UDeriv):
        return True
    if isinstance(node, Unary):
        return depends_on_u(node.operand)
    if isinstance(node, BinOp):
        return depends_on_u(node.left) or depends_on_u(node.right)
    if isinstance(node, Call):
        return depends_on_u(node.arg)
    return False


def is_linear_in_u(node: Node) -> bool:
    """Whether the expression is AFFINE in u and its derivatives.
    Conservative: u inside a function, u**p or u·u_x report nonlinear."""
    if isinstance(node, (Num, Const, Coord, UDeriv, Param)):
        return True
    if isinstance(node, Unary):
        return is_linear_in_u(node.operand)
    if isinstance(node, Call):
        return not depends_on_u(node.arg)
    if isinstance(node, BinOp):
        if node.op in ("+", "-"):
            return is_linear_in_u(node.left) and is_linear_in_u(node.right)
        if node.op == "*":
            lu, ru = depends_on_u(node.left), depends_on_u(node.right)
            if lu and ru:
                return False
            if lu:
                return is_linear_in_u(node.left)
            if ru:
                return is_linear_in_u(node.right)
            return True
        if node.op == "/":
            if depends_on_u(node.right):
                return False
            return is_linear_in_u(node.left)
        if node.op == "**":
            return not (depends_on_u(node.left) or depends_on_u(node.right))
    return False


def collect_indices(node: Node) -> Set[MultiIndex]:
    out: Set[MultiIndex] = set()

    def walk(n: Node):
        if isinstance(n, UDeriv):
            out.add(n.index)
        elif isinstance(n, Unary):
            walk(n.operand)
        elif isinstance(n, BinOp):
            walk(n.left)
            walk(n.right)
        elif isinstance(n, Call):
            walk(n.arg)

    walk(node)
    return out


def _evaluate(
    node: Node,
    z: Tensor,
    u_parts: Dict[MultiIndex, Tensor],
    coef: Optional[Dict[str, Tensor]] = None,
) -> Tensor:
    # literals are 0-d CPU tensors: they enter CUDA ops as scalars, where a
    # CUDA literal would cost a synchronising host-to-device copy
    if isinstance(node, Num):
        return torch.tensor(node.value, dtype=z.dtype, device="cpu")
    if isinstance(node, Const):
        return torch.tensor(_CONSTANTS[node.name], dtype=z.dtype, device="cpu")
    if isinstance(node, Coord):
        return z[:, node.index : node.index + 1]
    if isinstance(node, UDeriv):
        part = u_parts[node.index]
        if node.field >= part.shape[1]:
            raise ValueError(
                f"equation reads field column {node.field} but the predictor "
                f"outputs {part.shape[1]} component(s) — out_dim must match "
                f"the system's field count"
            )
        if node.field == 0 and part.shape[1] == 1:
            return part
        return part[:, node.field : node.field + 1]
    if isinstance(node, Param):
        if coef is None or node.name not in coef:
            raise KeyError(
                f"equation parameter {node.name!r} has no value; pass "
                f"coef={{'{node.name}': ...}} to residual/evaluate"
            )
        return torch.as_tensor(coef[node.name], dtype=z.dtype, device=z.device)
    if isinstance(node, Unary):
        return -_evaluate(node.operand, z, u_parts, coef)
    if isinstance(node, Call):
        return _FUNCTIONS[node.fn](_evaluate(node.arg, z, u_parts, coef))
    if isinstance(node, BinOp):
        a = _evaluate(node.left, z, u_parts, coef)
        b = _evaluate(node.right, z, u_parts, coef)
        if node.op == "+":
            return a + b
        if node.op == "-":
            return a - b
        if node.op == "*":
            return a * b
        if node.op == "/":
            return a / b
        if node.op == "**":
            return a**b
    raise TypeError(f"unhandled node {node!r}")  # pragma: no cover


@dataclass(frozen=True)
class CompiledPDE:
    """A compiled residual: call as ``residual(f_u, z) -> [N, 1]``.

    ``indices`` is the set of u-derivative multi-indices the equation reads.
    """

    equation: str
    coords: Tuple[str, ...]
    ast: Node
    indices: frozenset
    param_names: Tuple[str, ...] = ()

    def residual(
        self,
        f_u: Callable[[Tensor], Tensor],
        z: Tensor,
        coef: Optional[Dict[str, Tensor]] = None,
    ) -> Tensor:
        u_parts = deriv.partials(f_u, z, self.indices)
        return _evaluate(self.ast, z, u_parts, coef)

    def evaluate(
        self,
        z: Tensor,
        u_parts: Dict[MultiIndex, Tensor],
        coef: Optional[Dict[str, Tensor]] = None,
    ) -> Tensor:
        """Evaluate the residual from precomputed u-partials."""
        return _evaluate(self.ast, z, u_parts, coef)

    def residual_fast(
        self,
        predictor,
        params,
        z: Tensor,
        coef: Optional[Dict[str, Tensor]] = None,
    ) -> Tensor:
        """Residual with the u-partials from the structure-aware dispatcher
        (tpinn_torch.core.taylor.fast_partials): kernel B1 for plain dense
        nets at order ≤ 2, the generic jvp engine for everything else."""
        from tpinn_torch.core import taylor

        parts = taylor.fast_partials(
            predictor, params, z, self.indices, self.max_order
        )
        return _evaluate(self.ast, z, parts, coef)

    def __call__(
        self,
        f_u: Callable[[Tensor], Tensor],
        z: Tensor,
        coef: Optional[Dict[str, Tensor]] = None,
    ) -> Tensor:
        return self.residual(f_u, z, coef)

    @property
    def max_order(self) -> int:
        return max((len(ix) for ix in self.indices), default=0)

    @property
    def is_linear(self) -> bool:
        return is_linear_in_u(self.ast)


def compile_pde(
    equation: str, coords: Sequence[str], params: Sequence[str] = ()
) -> CompiledPDE:
    """Compile an equation string over the named coordinates.

    >>> pde = compile_pde("u_rr + 1/r*u_r + 1/r**2*u_tt", coords=("r", "t"))
    >>> f = pde.residual(f_u, z)   # [N, 1] residual at collocation points
    """
    ast = parse(equation, coords, params)
    return CompiledPDE(
        equation=equation,
        coords=tuple(coords),
        ast=ast,
        indices=frozenset(collect_indices(ast)),
        param_names=tuple(params),
    )


def infer_coords(equation: str) -> Tuple[str, ...]:
    """Infer the coordinate tuple from the identifiers an equation uses:
    ``r``/``t`` → ("r", "t"), ``x``/``y`` → ("x", "y"), ``x``/``t`` →
    ("x", "t"), a lone ``x`` → ("x",).  Mixing polar and cartesian names
    is rejected."""
    s = equation.replace(" ", "")
    used: set = set()
    for m in re.finditer(r"u_([a-z]{1,3})|(?<![a-z_])([xyrt])(?![a-z(])", s):
        if m.group(1):
            used.update(m.group(1))
        elif m.group(2):
            used.add(m.group(2))
    used &= {"x", "y", "r", "t"}
    if "r" in used:
        if "x" in used or "y" in used:
            raise PDESyntaxError(
                f"equation mixes polar (r/t) and cartesian (x/y) names: "
                f"{equation!r}"
            )
        return ("r", "t")
    if "y" in used:
        return ("x", "y")
    if "t" in used:
        return ("x", "t")
    return ("x",)


def validate_equation(
    expr: str,
    coords: Sequence[str] = ("x", "y", "r", "t"),
    params: Sequence[str] = (),
) -> bool:
    """UI-grammar validation: True iff the expression parses (empty counts
    as valid, as in the UI)."""
    if not expr or not expr.strip():
        return True
    try:
        parse(expr, coords, params)
        return True
    except PDESyntaxError:
        return False


def compile_coord_expr(expr: str, coords: Sequence[str]) -> Callable[[Tensor], Tensor]:
    """Compile an expression of the coordinates into ``g(z) -> [N, 1]``."""
    ast = parse(expr, coords)
    if collect_indices(ast):
        raise PDESyntaxError(f"expression {expr!r} must not reference u")

    def g(z: Tensor) -> Tensor:
        val = _evaluate(ast, z, {})
        if val.device != z.device:  # a constant expression: a CPU literal
            return torch.full((z.shape[0], 1), val.item(), dtype=z.dtype,
                              device=z.device)
        return torch.broadcast_to(val, (z.shape[0], 1)).to(z.dtype)

    return g
