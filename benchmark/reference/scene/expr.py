# Frozen copy of euclider_tpu_torch/scene/expr.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""Tiny math-expression language for expression-driven space warps.

Port note: a copy of ``euclider_tpu/scene/expr.py`` whose jax function
library ``jax_lib`` becomes ``torch_lib``, so that the scene front end loads
without jax.  The parser, the postfix lowering and the VM depth check are
unchanged; ``eval_ast`` divides a tensor by a Python number (or a number by
a tensor) through a 0-dim tensor (``_true_div``).

Reference parity: euclider's expression-driven warped-space material
(the ``ComponentTransformation``-style material whose behaviour is given by
user-written math expressions parsed at scene-load time; SURVEY.md §2.1
'Materials & transitions' [K-low row]).  The reference parsed expressions
with the ``meval`` crate and evaluated them per ray step; here an expression
compiles once into a **hashable AST** that becomes part of the scene's
static topology — the traced XLA program contains the expression's
arithmetic as straight-line vector code, evaluated per march step on whole
ray batches (zero interpretation overhead at run time).

Grammar (classic precedence, ``^`` is right-associative power):

    expr   := term  (('+'|'-') term)*
    term   := unary (('*'|'/') unary)*
    unary  := '-' unary | power
    power  := atom ('^' unary)?
    atom   := NUMBER | NAME | NAME '(' expr (',' expr)* ')' | '(' expr ')'

Variables: ``x y z w`` (ray position components), ``p0``..``p7``
(differentiable per-material parameters living in SceneTables — gradients
flow through them), and ``t`` (the scene time passed to the render — the
reference's ``trace(time, ...)`` argument, SURVEY.md §3.3; enables animated
warped spaces).  Constant: ``pi``.  Functions: ``sin cos tanh exp log
sqrt abs floor sign min max atan asin acos atan2`` — all built from
Mosaic-lowerable primitives (ops.mathx supplies the arc family) so the same
AST runs in the lax backend, the Pallas TPU kernel, and the NumPy oracle.

The AST is nested tuples — hashable, comparable, and safe as a jit static
argument:

    ('num', 2.0) | ('var', 'x') | ('neg', a)
    ('add'|'sub'|'mul'|'div'|'pow', a, b) | ('call', name, (args...))
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

Ast = Tuple[Any, ...]

_FUNCS1 = ("sin", "cos", "tanh", "exp", "log", "sqrt", "abs", "floor",
           "sign", "atan", "asin", "acos")
_FUNCS2 = ("min", "max", "atan2")
VARS = ("x", "y", "z", "w") + tuple(f"p{i}" for i in range(8)) + ("t",)

# Evaluation-stack capacity of the C++ oracle's VM (oracle/native/oracle.cpp
# eval_prog: `double st[VM_STACK]`).  Programs deeper than this are rejected
# at IR-validation time so an adversarial scene JSON can never overflow the
# native stack.
VM_STACK = 64


class ExprError(ValueError):
    pass


# ---------------------------------------------------------------------------
# tokenizer / parser
# ---------------------------------------------------------------------------

def _tokenize(src: str):
    toks = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if c in "+-*/^(),":
            toks.append((c, c))
            i += 1
            continue
        if c.isdigit() or c == ".":
            j = i
            seen_e = False
            while j < n and (src[j].isdigit() or src[j] == "."
                             or src[j] in "eE"
                             or (seen_e and src[j] in "+-"
                                 and src[j - 1] in "eE")):
                if src[j] in "eE":
                    seen_e = True
                j += 1
            try:
                val = float(src[i:j])
            except ValueError:
                raise ExprError(f"bad number at {i}: {src[i:j]!r}")
            toks.append(("num", val))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(("name", src[i:j]))
            i = j
            continue
        raise ExprError(f"unexpected character {c!r} at {i} in {src!r}")
    toks.append(("end", None))
    return toks


def parse(src: str) -> Ast:
    """Parse an expression string into a hashable AST (validates names)."""
    toks = _tokenize(src)
    pos = [0]

    def peek():
        return toks[pos[0]]

    def take(kind=None):
        t = toks[pos[0]]
        if kind is not None and t[0] != kind:
            raise ExprError(f"expected {kind!r}, got {t[0]!r} in {src!r}")
        pos[0] += 1
        return t

    def expr():
        node = term()
        while peek()[0] in ("+", "-"):
            op = take()[0]
            node = ("add" if op == "+" else "sub", node, term())
        return node

    def term():
        node = unary()
        while peek()[0] in ("*", "/"):
            op = take()[0]
            node = ("mul" if op == "*" else "div", node, unary())
        return node

    def unary():
        if peek()[0] == "-":
            take()
            return ("neg", unary())
        return power()

    def power():
        node = atom()
        if peek()[0] == "^":
            take()
            return ("pow", node, unary())
        return node

    def atom():
        t = take()
        if t[0] == "num":
            return ("num", t[1])
        if t[0] == "(":
            node = expr()
            take(")")
            return node
        if t[0] == "name":
            name = t[1]
            if peek()[0] == "(":
                take("(")
                args = [expr()]
                while peek()[0] == ",":
                    take(",")
                    args.append(expr())
                take(")")
                if name in _FUNCS1 and len(args) == 1:
                    return ("call", name, tuple(args))
                if name in _FUNCS2 and len(args) == 2:
                    return ("call", name, tuple(args))
                raise ExprError(f"unknown function {name}/{len(args)}")
            if name == "pi":
                return ("num", math.pi)
            if name in VARS:
                return ("var", name)
            raise ExprError(f"unknown variable {name!r} (have {VARS})")
        raise ExprError(f"unexpected token {t!r} in {src!r}")

    node = expr()
    take("end")
    return node


def unparse(node: Ast) -> str:
    """AST -> canonical string (for JSON round-trips / repr)."""
    k = node[0]
    if k == "num":
        return repr(node[1])
    if k == "var":
        return node[1]
    if k == "neg":
        return f"(-{unparse(node[1])})"
    if k in ("add", "sub", "mul", "div", "pow"):
        op = {"add": "+", "sub": "-", "mul": "*", "div": "/", "pow": "^"}[k]
        return f"({unparse(node[1])} {op} {unparse(node[2])})"
    if k == "call":
        return f"{node[1]}({', '.join(unparse(a) for a in node[2])})"
    raise ExprError(f"bad AST node {node!r}")


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _true_div(a, b):
    """a / b, where a Python number divided by or into a torch tensor first
    becomes a 0-dim tensor like it: on a CUDA device torch divides by a
    Python number as a product with its rounded reciprocal, where the
    kernels and the JAX package divide.  Floats and arrays divide as they
    are."""
    if isinstance(b, (int, float)) and hasattr(a, "new_full"):
        b = a.new_full((), b)
    elif isinstance(a, (int, float)) and hasattr(b, "new_full"):
        a = b.new_full((), a)
    return a / b


def eval_ast(node: Ast, env: Dict[str, Any], lib):
    """Evaluate an AST with a function library.

    ``lib`` supplies the transcendental implementations, e.g.
    ``numpy_lib()`` for scalar float64 evaluation.  ``env`` maps variable
    names to (possibly batched) values; missing ``p*`` vars default to 0.
    """
    k = node[0]
    if k == "num":
        return lib["const"](node[1])
    if k == "var":
        v = env.get(node[1])
        if v is None:
            if node[1].startswith("p"):
                return lib["const"](0.0)
            raise ExprError(f"unbound variable {node[1]!r}")
        return v
    if k == "neg":
        return -eval_ast(node[1], env, lib)
    if k in ("add", "sub", "mul", "div"):
        a = eval_ast(node[1], env, lib)
        b = eval_ast(node[2], env, lib)
        if k == "add":
            return a + b
        if k == "sub":
            return a - b
        if k == "mul":
            return a * b
        div = lib.get("div")
        return div(a, b) if div is not None else _true_div(a, b)
    if k == "pow":
        a = eval_ast(node[1], env, lib)
        e = node[2]
        # integer literal exponents become repeated multiplication —
        # exact, cheap, and avoids a pow lowering in Mosaic
        if e[0] == "num" and float(e[1]).is_integer() and abs(e[1]) <= 16:
            n = int(e[1])
            if n == 0:
                # unconditional 1 (broadcast to a's shape), matching the C++
                # VM's powi n==0 even for non-finite a — `1 + 0*a` would
                # produce NaN there and break the bit-match contract
                return lib["ones_like"](a)
            acc = a
            for _ in range(abs(n) - 1):
                acc = acc * a
            if n < 0:
                # the reciprocal is a division: route it through the lib's
                # (possibly safe-guarded) div so x^-n at x == 0 on a masked
                # lane cannot ride 0*inf into the gradients (ADVICE r3);
                # the unguarded numpy/C++ paths keep raw 1/acc for
                # bit-exact oracle parity
                div = lib.get("div")
                return div(1.0, acc) if div is not None else _true_div(1.0,
                                                                       acc)
            return acc
        b = eval_ast(e, env, lib)
        return lib["exp"](b * lib["log"](a))
    if k == "call":
        args = [eval_ast(a, env, lib) for a in node[2]]
        return lib[node[1]](*args)
    raise ExprError(f"bad AST node {node!r}")


def torch_lib(safe: bool = False, device=None, dtype=None):
    """Function library for batched torch evaluation: the port of
    ``jax_lib`` (the plain version's field, ``ops/trace.py::make_accel``).

    The arc family comes from ``ops/mathx.py`` (the polynomial, as lax and
    the CUDA kernels use), not ``torch.atan2``/``torch.asin``.  A function
    applied to a Python float (a constant argument) computes in ``dtype``
    (float32 by default) on ``device``, as jax does with a weak-typed float
    (float64 under its x64 flag).  ``safe=True``
    domain-guards sqrt, log, asin, acos and div with the double-where
    pattern of ``jax_lib(safe=True)``: the out-of-domain input is replaced
    before the primitive runs, so neither the value nor its gradient is
    NaN or inf there.  Gradients are autograd's, which agree with jax's on
    every function: zero for floor and sign, select(x >= 0, 1, -1) for abs
    (``mathx.abs``), half to each side of a tie of min and max."""
    import torch

    from ..ops import mathx

    def t(x):
        return (x if isinstance(x, torch.Tensor)
                else torch.tensor(float(x), dtype=dtype or torch.float32,
                                  device=device))

    def f1(fn):
        return lambda x: fn(t(x))

    def f2(fn):
        return lambda a, b: fn(*torch.broadcast_tensors(t(a), t(b)))

    lib = {
        "const": float,
        "ones_like": lambda a: torch.ones_like(t(a)),
        "sin": f1(torch.sin), "cos": f1(torch.cos), "tanh": f1(torch.tanh),
        "exp": f1(torch.exp), "log": f1(torch.log), "sqrt": f1(torch.sqrt),
        "abs": f1(mathx.abs), "floor": f1(torch.floor),
        "sign": f1(torch.sign),
        "min": f2(torch.minimum), "max": f2(torch.maximum),
        "atan": f1(mathx.atan), "asin": f1(mathx.asin),
        "acos": f1(mathx.acos), "atan2": f2(mathx.atan2),
    }
    if not safe:
        return lib

    def guard1(ok_fn, fn, inner, fallback):
        """where(ok, fn(where(ok, x, inner)), fallback(x)): both branches
        finite everywhere, so the VJP never sees 0*NaN."""
        def g(x):
            x = t(x)
            ok = ok_fn(x)
            return torch.where(ok, fn(torch.where(ok, x, inner)),
                               fallback(x))
        return g

    half_pi = math.pi / 2.0
    lib["sqrt"] = guard1(lambda x: x > 0, torch.sqrt, 1.0,
                         lambda x: torch.zeros_like(x))
    lib["log"] = guard1(lambda x: x > 0, torch.log, 1.0,
                        lambda x: torch.zeros_like(x))
    lib["asin"] = guard1(lambda x: torch.abs(x) < 1, mathx.asin, 0.0,
                         lambda x: torch.sign(x) * half_pi)
    lib["acos"] = guard1(lambda x: torch.abs(x) < 1, mathx.acos, 0.0,
                         lambda x: torch.where(x > 0, 0.0, math.pi))

    def safe_div(a, b):
        # guard only b == 0, the true singularity (jax_lib's rule)
        b = t(b)
        ok = b != 0
        return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)

    lib["div"] = safe_div
    return lib


def numpy_lib():
    """Function library for the scalar NumPy oracle (float64)."""
    import numpy as np

    return {
        "const": float,
        "ones_like": lambda a: np.ones_like(a),
        "sin": np.sin, "cos": np.cos, "tanh": np.tanh,
        "exp": np.exp, "log": np.log, "sqrt": np.sqrt,
        "abs": np.abs, "floor": np.floor, "sign": np.sign,
        "min": np.minimum, "max": np.maximum,
        "atan": np.arctan, "asin": np.arcsin, "acos": np.arccos,
        "atan2": np.arctan2,
    }


# ---------------------------------------------------------------------------
# postfix compilation (for the C++ oracle's stack VM — oracle/native/oracle.cpp)
# ---------------------------------------------------------------------------

# opcode table shared with the C++ evaluator; vals carry the operand
OPS = {"const": 0, "var": 1, "add": 2, "sub": 3, "mul": 4, "div": 5,
       "neg": 6, "powi": 7, "powf": 8,
       "sin": 9, "cos": 10, "tanh": 11, "exp": 12, "log": 13, "sqrt": 14,
       "abs": 15, "floor": 16, "sign": 17, "atan": 18, "asin": 19,
       "acos": 20, "min": 21, "max": 22, "atan2": 23}
VAR_INDEX = {v: i for i, v in enumerate(VARS)}  # x y z w p0..p7 -> 0..11


def postfix_depth(node: Ast) -> int:
    """Max evaluation-stack depth of the postfix lowering of ``node``.

    Computed from the same emission order as to_postfix: operands are pushed
    left-to-right, so depth(binary a op b) = max(d(a), 1 + d(b)) and calls
    stack each argument on top of the previous ones."""
    k = node[0]
    if k in ("num", "var"):
        return 1
    if k == "neg":
        return postfix_depth(node[1])
    if k == "pow":
        e = node[2]
        if e[0] == "num" and float(e[1]).is_integer() and abs(e[1]) <= 16:
            return postfix_depth(node[1])          # powi: in-place
        return max(postfix_depth(node[1]), 1 + postfix_depth(e))
    if k in ("add", "sub", "mul", "div"):
        return max(postfix_depth(node[1]), 1 + postfix_depth(node[2]))
    if k == "call":
        return max(i + postfix_depth(a) for i, a in enumerate(node[2]))
    raise ExprError(f"bad AST node {node!r}")


def check_vm_depth(node: Ast, src: str = "") -> None:
    """Reject expressions whose postfix program would overflow the C++
    oracle's fixed evaluation stack (VM_STACK doubles)."""
    d = postfix_depth(node)
    if d > VM_STACK:
        what = f"expression {src!r}" if src else "expression"
        raise ExprError(
            f"{what} needs stack depth {d}, exceeding the native VM limit "
            f"of {VM_STACK}; flatten the nesting (left-associated chains "
            f"evaluate in O(1) stack)")


def to_postfix(node: Ast):
    """Lower an AST to a postfix (ops, vals) program with eval_ast's exact
    arithmetic (integer-literal powers become the same repeated-multiply
    recurrence, others exp(b*log(a))) so C++ matches NumPy bit-for-bit.

    Raises ExprError if the program's stack depth exceeds VM_STACK (the
    C++ VM's fixed stack) — IR validation (ExprSpace) rejects such
    expressions up front, this is the backstop."""
    check_vm_depth(node)
    ops, vals = [], []

    def emit(op, val=0.0):
        ops.append(OPS[op])
        vals.append(float(val))

    def walk(n):
        k = n[0]
        if k == "num":
            emit("const", n[1])
        elif k == "var":
            emit("var", VAR_INDEX[n[1]])
        elif k == "neg":
            walk(n[1])
            emit("neg")
        elif k == "pow":
            e = n[2]
            if e[0] == "num" and float(e[1]).is_integer() and abs(e[1]) <= 16:
                walk(n[1])
                emit("powi", int(e[1]))
            else:
                walk(n[1])
                walk(e)
                emit("powf")
        elif k in ("add", "sub", "mul", "div"):
            walk(n[1])
            walk(n[2])
            emit(k)
        elif k == "call":
            for a in n[2]:
                walk(a)
            emit(n[1])
        else:
            raise ExprError(f"bad AST node {n!r}")

    walk(node)
    return ops, vals


def free_params(node: Ast) -> Tuple[int, ...]:
    """Indices of p* parameters referenced by the AST."""
    k = node[0]
    if k == "var" and node[1].startswith("p"):
        return (int(node[1][1:]),)
    if k in ("neg",):
        return free_params(node[1])
    if k in ("add", "sub", "mul", "div", "pow"):
        return tuple(sorted(set(free_params(node[1])
                                + free_params(node[2]))))
    if k == "call":
        out = ()
        for a in node[2]:
            out = out + free_params(a)
        return tuple(sorted(set(out)))
    return ()
