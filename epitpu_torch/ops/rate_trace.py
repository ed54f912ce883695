"""A model's rate function as a per-lane scalar program, and the C++ functor
the tau-leap kernel is instantiated on for it.

epitpu's Pallas kernel calls ``model.rate_fn`` while it is traced
(``epitpu/ops/tauleap_pallas.py:_make_substep``), so it runs any model whose
reactions have unique sources.  The CUDA kernel (``csrc/tauleap_kernel.cuh``)
is a template over a functor; this module makes that functor for a model
that has no hand-written one:

* ``trace_rates(model)`` traces ``model.rate_fn`` with ``make_fx`` on
  example inputs ``x [2, C]`` and ``theta [2, d]`` and lowers the aten graph
  to a program over one lane, in which every value is a list of scalars over
  its last axis (one scalar for a value of shape ``[B]``);
* ``RateProgram.evaluate(x, theta)`` runs that program with the same torch
  operations, one column a scalar: the trace's CPU oracle;
* ``functor_source(model)`` writes the program as C++ with the hand functors'
  interface (``csrc/tauleap.cu``): ``kC``, ``kR``, ``kCoef``, ``src(r)``,
  ``load(th, r, coef)`` (only the theta entries reaction r reads),
  ``rate(x, coef, r)`` (a switch over r) and ``apply(x, e)`` (the
  stoichiometry row by row, compartment by compartment, in the order of
  ``epitpu_torch.sim.tauleap.substep``).  Its functions carry ``EPI_FN``:
  ``__host__ __device__`` under nvcc, plain inline C++ under a host
  compiler, so the same text compiles on the host for a CPU test.

The C++ performs the program's float operations in the program's order
(``sum`` left to right; IEEE division, no fast math), so a functor traced
from a built-in model's ``rate_fn`` rounds like the hand-written one.

Supported: ``select``, ``unbind``, ``slice``, ``stack`` and ``cat`` on the
last axis; ``sum`` over the last axis; ``add``, ``sub``, ``mul``, ``div`` and
``neg`` (and ``reciprocal``, which ``c / x`` traces to) with tensors or
scalars; ``clamp``, ``clamp_min``, ``clamp_max``,
``maximum``, ``minimum``, ``where``, the comparisons, ``abs``, ``exp``,
``log``, ``log1p``, ``expm1``, ``sqrt``, ``pow`` with a scalar exponent;
scalar constants.  Any other op, or an op along the lane axis (a rate that
mixes lanes), raises ``NotImplementedError`` naming the aten op.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Tuple

import numpy as np
import torch

SUPPORTED = (
    "select", "unbind", "slice", "stack", "cat", "sum (last axis)", "add", "sub", "mul",
    "div", "neg", "reciprocal", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "where",
    "gt", "ge", "lt", "le", "eq", "ne", "abs", "exp", "log", "log1p", "expm1", "sqrt",
    "pow (scalar exponent)", "constants",
)

_UNARY = {"neg": (torch.neg, "-{0}"), "abs": (torch.abs, "fabsf({0})"),
          "exp": (torch.exp, "expf({0})"), "log": (torch.log, "logf({0})"),
          "log1p": (torch.log1p, "log1pf({0})"), "expm1": (torch.expm1, "expm1f({0})"),
          "sqrt": (torch.sqrt, "sqrtf({0})"),
          # c / x traces as reciprocal(x) * c (torch/_tensor.py:__rdiv__)
          "reciprocal": (torch.reciprocal, "1.0f / {0}")}
_BINARY = {"add": (torch.add, "{0} + {1}"), "sub": (torch.sub, "{0} - {1}"),
           "mul": (torch.mul, "{0} * {1}"), "div": (torch.div, "{0} / {1}"),
           "maximum": (torch.maximum, "epi_maximum({0}, {1})"),
           "minimum": (torch.minimum, "epi_minimum({0}, {1})"),
           # torch.clamp's order: NaN stays NaN
           "clamp_min": (lambda a, lo: torch.clamp(a, min=lo), "({0} < {1}) ? {1} : {0}"),
           "clamp_max": (lambda a, hi: torch.clamp(a, max=hi), "({1} < {0}) ? {1} : {0}")}
_COMPARE = {"gt": (torch.gt, "{0} > {1}"), "ge": (torch.ge, "{0} >= {1}"),
            "lt": (torch.lt, "{0} < {1}"), "le": (torch.le, "{0} <= {1}"),
            "eq": (torch.eq, "{0} == {1}"), "ne": (torch.ne, "{0} != {1}")}
# the ops torch's pow kernel computes without pow() (ATen PowKernel.cpp)
_POW = {2.0: "{0} * {0}", 3.0: "{0} * {0} * {0}", 0.5: "sqrtf({0})",
        -1.0: "1.0f / {0}", -2.0: "1.0f / ({0} * {0})"}


@dataclasses.dataclass(frozen=True)
class Op:
    """One scalar of the program: a leaf (``"x"`` or ``"theta"`` with its
    index, ``"const"`` with its value) or an operation on earlier values
    (``args`` are their ids; ``pow`` also holds its exponent)."""

    kind: str
    args: tuple
    boolean: bool = False


@dataclasses.dataclass(frozen=True)
class _Val:
    """A traced tensor: the scalar ids over its last axis; ``vec`` False for
    a value of shape ``[B]`` (one id)."""

    ids: Tuple[int, ...]
    vec: bool


class RateProgram:
    """The lowered program: ``ops`` in evaluation order, ``outputs[r]`` the
    id of reaction r's rate."""

    def __init__(self, ops, outputs):
        self.ops = tuple(ops)
        self.outputs = tuple(outputs)

    def closure(self, r):
        """Ids of the ops reaction r's rate needs, in program order."""
        need, stack = set(), [self.outputs[r]]
        while stack:
            i = stack.pop()
            if i in need:
                continue
            need.add(i)
            op = self.ops[i]
            if op.kind not in ("x", "theta", "const"):
                stack.extend(op.args[:1] if op.kind == "pow" else op.args)
        return sorted(need)

    def thetas_read(self, r):
        return sorted(self.ops[i].args[0] for i in self.closure(r) if self.ops[i].kind == "theta")

    def operations(self):
        """Float operations (arithmetic, comparisons, selects,
        transcendentals; a fused special-case pow as its ops) of one lane's
        rates, each op the outputs need counted once however many reactions
        share it: the least work of a lane's rates per substep."""
        n = 0
        for i in sorted(set().union(*(self.closure(r) for r in range(len(self.outputs))))):
            op = self.ops[i]
            if op.kind in ("x", "theta", "const"):
                continue
            n += {2.0: 1, 3.0: 2, -2.0: 2}.get(op.args[1], 1) if op.kind == "pow" else 1
        return n

    def evaluate(self, x, theta):
        """The program on ``x [B, C]`` and ``theta [B, d]`` with torch's
        operations, one column a scalar -> ``[B, R]``."""
        vals = []
        for op in self.ops:
            if op.kind == "x":
                v = x[:, op.args[0]]
            elif op.kind == "theta":
                v = theta[:, op.args[0]]
            elif op.kind == "const":
                v = op.args[0]
            else:
                a = [vals[i] for i in (op.args[:1] if op.kind == "pow" else op.args)]
                # a python number stays one (torch treats it as the traced op
                # did), except where torch's function needs a tensor
                if not isinstance(a[0], torch.Tensor) or op.kind in ("maximum", "minimum"):
                    a = [t if isinstance(t, torch.Tensor) else
                         torch.tensor(t, dtype=torch.float32) for t in a]
                v = _torch_op(op, a)
            vals.append(v)
        b = x.shape[0]
        cols = [vals[i] if isinstance(vals[i], torch.Tensor) and vals[i].dim() == 1
                else torch.full((b,), float(vals[i]), dtype=torch.float32) for i in self.outputs]
        return torch.stack(cols, dim=-1)


def _torch_op(op, a):
    if op.kind in _UNARY:
        return _UNARY[op.kind][0](a[0])
    if op.kind in _BINARY:
        return _BINARY[op.kind][0](a[0], a[1])
    if op.kind in _COMPARE:
        return _COMPARE[op.kind][0](a[0], a[1])
    if op.kind == "pow":
        return torch.pow(a[0], op.args[1])
    if op.kind == "where":
        return torch.where(a[0], a[1], a[2])
    if op.kind == "to_float":
        return a[0].to(torch.float32)
    raise AssertionError(op.kind)


class _Lowering:
    """Walks the aten graph, building ``Op``s (shared by identical
    expressions: every op is pure)."""

    def __init__(self, n_x, n_theta):
        self.ops, self.memo = [], {}
        self.x = _Val(tuple(self.op("x", (c,)) for c in range(n_x)), True)
        self.theta = _Val(tuple(self.op("theta", (j,)) for j in range(n_theta)), True)

    def op(self, kind, args, boolean=False):
        key = (kind, args, boolean)
        if key not in self.memo:
            self.memo[key] = len(self.ops)
            self.ops.append(Op(kind, args, boolean))
        return self.memo[key]

    def const(self, v):
        return self.op("const", (float(v),))

    def scalar(self, v, name):
        """A python number, a 0-d constant or a traced value's ids."""
        if isinstance(v, _Val):
            return v
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise NotImplementedError(f"rate trace: {name} with operand {v!r}; supported: "
                                      f"{', '.join(SUPPORTED)}")
        return _Val((self.const(v),), None)  # broadcasts against anything

    def elementwise(self, name, kind, operands, boolean=False, extra=()):
        vals = [self.scalar(v, name) for v in operands]
        shaped = [v for v in vals if v.vec is not None]
        if shaped and any(v.vec != shaped[0].vec for v in shaped):
            raise NotImplementedError(
                f"rate trace: {name} broadcasts a [B] value against a [B, L] value, which "
                "pairs the lane axis with the last axis (a rate that mixes lanes)")
        width = max(len(v.ids) for v in vals)
        if any(len(v.ids) not in (1, width) for v in vals):
            raise ValueError(f"rate trace: {name} on last axes of lengths "
                             f"{[len(v.ids) for v in vals]}")
        ids = tuple(self.op(kind, tuple(v.ids[0 if len(v.ids) == 1 else i] for v in vals)
                            + extra, boolean) for i in range(width))
        vec = shaped[0].vec if shaped else False
        return _Val(ids, vec)


def _unsupported(target, why="not in the supported set"):
    return NotImplementedError(
        f"rate trace: aten op {target} is {why}; supported: {', '.join(SUPPORTED)}")


def _last_axis(v, dim, target):
    """Check that ``dim`` names the last axis of ``v`` (rank 2 for a
    ``[B, L]`` value, rank 1 for ``[B]``, whose only axis is the lanes)."""
    rank = 2 if v.vec else 1
    if v.vec and dim in (1, -1):
        return
    raise _unsupported(target, f"applied along axis {dim} of a rank-{rank} value, the lane "
                               "axis (a rate that mixes lanes)")


def _lower_node(low, node, env):
    target = node.target

    def arg(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(arg(b) for b in a)
        return a

    args = [arg(a) for a in node.args]
    kw = {k: arg(v) for k, v in node.kwargs.items()}
    if target is operator.getitem:
        return args[0][args[1]]
    name = getattr(target, "__name__", str(target))
    packet = name.split(".")[0]
    if packet in ("clone", "alias", "detach", "lift_fresh_copy", "contiguous"):
        return args[0]
    if packet in ("add", "sub", "rsub"):
        if kw.get("alpha", args[2] if len(args) > 2 else 1) != 1:
            raise _unsupported(target, "used with alpha != 1")
        a, b = args[:2]
        if packet == "rsub":
            a, b = b, a
        return low.elementwise(name, "add" if packet == "add" else "sub", (a, b))
    if packet in ("mul", "div"):
        if name == "div.Tensor_mode":
            raise _unsupported(target, "a rounding division")
        return low.elementwise(name, packet, args[:2])
    if packet in _UNARY:
        return low.elementwise(name, packet, args[:1])
    if packet in ("maximum", "minimum"):
        return low.elementwise(name, packet, args[:2])
    if packet in _COMPARE:
        return low.elementwise(name, packet, args[:2], boolean=True)
    if packet == "where" and name != "where.default":
        return low.elementwise(name, "where", args[:3])
    if name == "pow.Tensor_Scalar":
        e = args[1]
        if isinstance(e, bool) or not isinstance(e, (int, float)):
            raise _unsupported(target, "used with a non-scalar exponent")
        return low.elementwise(name, "pow", args[:1], extra=(float(e),))
    if packet in ("clamp", "clamp_min", "clamp_max") and name in (
            "clamp.default", "clamp_min.default", "clamp_max.default"):
        lo = kw.get("min", args[1] if len(args) > 1 else None)
        hi = kw.get("max", args[2] if len(args) > 2 else None)
        if packet == "clamp_max":
            lo, hi = None, args[1]
        v = args[0]
        if lo is not None:
            v = low.elementwise(name, "clamp_min", (v, lo))
        if hi is not None:
            v = low.elementwise(name, "clamp_max", (v, hi))
        return v
    if name == "_to_copy.default":
        dtype = kw.get("dtype")
        v = args[0]
        src_bool = all(low.ops[i].boolean for i in v.ids)
        if dtype in (None, torch.float32):
            return low.elementwise(name, "to_float", (v,)) if src_bool else v
        raise _unsupported(target, f"a conversion to {dtype}")
    if name == "select.int":
        v, dim, idx = args
        _last_axis(v, dim, target)
        return _Val((v.ids[idx],), False)
    if name == "slice.Tensor":
        v, dim, start, end, step = (args + [0, None, None, 1][len(args) - 1:])[:5]
        _last_axis(v, dim, target)
        return _Val(v.ids[slice(start, end, step)], True)
    if name == "unbind.int":
        v = args[0]
        _last_axis(v, args[1] if len(args) > 1 else 0, target)
        return tuple(_Val((i,), False) for i in v.ids)
    if name in ("stack.default", "cat.default"):
        vals = [low.scalar(v, name) for v in args[0]]
        dim = args[1] if len(args) > 1 else 0
        if name == "stack.default":
            if dim not in (1, -1) or any(v.vec for v in vals):
                raise _unsupported(target, "used other than to stack [B] values on a new last "
                                           "axis")
        else:
            for v in vals:
                _last_axis(v, dim, target)
        return _Val(tuple(i for v in vals for i in v.ids), True)
    if name == "sum.dim_IntList":
        v, dims = args[0], args[1]
        keep = kw.get("keepdim", args[2] if len(args) > 2 else False)
        if dims is None or len(dims) != 1:
            raise _unsupported(target, f"a sum over axes {dims}")
        _last_axis(v, dims[0], target)
        acc = v.ids[0]
        for i in v.ids[1:]:
            acc = low.op("add", (acc, i))
        return _Val((acc,), True if keep else False)
    if name == "unsqueeze.default":
        v = args[0]
        if v.vec or args[1] not in (1, -1):
            raise _unsupported(target, f"unsqueeze at axis {args[1]} of a rank-"
                                       f"{2 if v.vec else 1} value")
        return _Val(v.ids, True)
    if name == "squeeze.dim":
        v = args[0]
        if not v.vec or len(v.ids) != 1 or args[1] not in (1, -1):
            raise _unsupported(target, "a squeeze other than of a last axis of length 1")
        return _Val(v.ids, False)
    if name in ("zeros_like.default", "ones_like.default", "full_like.default"):
        fill = {"zeros_like": 0.0, "ones_like": 1.0}.get(packet)
        c = low.const(args[1] if fill is None else fill)
        return _Val((c,) * len(args[0].ids), args[0].vec)
    raise _unsupported(target)


def trace_rates(model) -> RateProgram:
    """``model.rate_fn`` traced on ``x [2, C]``, ``theta [2, d]`` and lowered
    to a ``RateProgram``; raises ``NotImplementedError`` for an op outside
    ``SUPPORTED`` or along the lane axis."""
    from torch.fx.experimental.proxy_tensor import make_fx

    c, d = model.num_compartments, model.theta_dim
    ex_x = torch.arange(1.0, 2 * c + 1.0).reshape(2, c)
    ex_th = torch.arange(1.0, 2 * d + 1.0).reshape(2, d) / 8.0
    gm = make_fx(model.rate_fn)(ex_x, ex_th)
    low = _Lowering(c, d)
    env, placeholders = {}, iter((low.x, low.theta))
    out = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(placeholders)
        elif node.op == "get_attr":
            t = getattr(gm, node.target)
            if t.dim() == 0:
                env[node] = float(t)
            elif t.dim() == 1:
                env[node] = _Val(tuple(low.const(v) for v in t.tolist()), True)
            else:
                raise _unsupported(f"constant of shape {tuple(t.shape)}")
        elif node.op == "call_function":
            env[node] = _lower_node(low, node, env)
        elif node.op == "output":
            out = env[node.args[0]] if isinstance(node.args[0], torch.fx.Node) else node.args[0]
        else:
            raise _unsupported(node.op)
    r = model.num_reactions
    if not isinstance(out, _Val) or not out.vec or len(out.ids) != r:
        raise ValueError(f"rate trace: {model.name}'s rate_fn must return [B, {r}]")
    if any(low.ops[i].boolean for i in out.ids):
        raise ValueError(f"rate trace: {model.name}'s rate_fn returns booleans")
    return RateProgram(low.ops, out.ids)


def _literal(v):
    f = float(np.float32(v))
    if math.isnan(f):
        return "NAN"
    if math.isinf(f):
        return "INFINITY" if f > 0 else "-INFINITY"
    return f"{f!r}f"


_PRELUDE = """#ifndef EPI_FN
#ifdef __CUDACC__
#define EPI_FN __host__ __device__ __forceinline__
#else
#define EPI_FN inline
#endif
#endif
#include <math.h>

// torch.maximum / torch.minimum: a NaN operand gives NaN
EPI_FN float epi_maximum(float a, float b) { return (a != a) ? a : ((b != b) ? b : ((a < b) ? b : a)); }
EPI_FN float epi_minimum(float a, float b) { return (a != a) ? a : ((b != b) ? b : ((b < a) ? b : a)); }
"""


def _reaction_body(prog, r, slots):
    """C++ statements computing reaction r's rate; returns (lines, result)."""
    names = {}
    lines = []
    for i in prog.closure(r):
        op = prog.ops[i]
        if op.kind == "x":
            names[i] = f"x[{op.args[0]}]"
        elif op.kind == "theta":
            names[i] = f"coef[{slots[op.args[0]]}]"
        elif op.kind == "const":
            names[i] = _literal(op.args[0])
        else:
            a = [names[j] for j in (op.args[:1] if op.kind == "pow" else op.args)]
            if op.kind == "pow":
                expr = _POW.get(op.args[1], "powf({0}, " + _literal(op.args[1]) + ")").format(*a)
            elif op.kind == "where":
                expr = f"{a[0]} ? {a[1]} : {a[2]}"
            elif op.kind == "to_float":
                expr = f"{a[0]} ? 1.0f : 0.0f"
            else:
                expr = {**_UNARY, **_BINARY, **_COMPARE}[op.kind][1].format(*a)
            names[i] = f"v{i}"
            lines.append(f"const {'bool' if op.boolean else 'float'} v{i} = {expr};")
    return lines, names[prog.outputs[r]]


def functor_source(model, program: RateProgram = None) -> str:
    """C++ of the functor ``GeneratedModel`` for ``model`` (module
    docstring): traced from its ``rate_fn`` unless ``program`` is given."""
    prog = trace_rates(model) if program is None else program
    c, r_dim = model.num_compartments, model.num_reactions
    reads = [prog.thetas_read(r) for r in range(r_dim)]
    k_coef = max([1] + [len(t) for t in reads])
    src = model.source.tolist()
    out = [_PRELUDE, f"// model {model.name!r}: rates traced from its rate_fn by "
           "epitpu_torch/ops/rate_trace.py",
           "struct GeneratedModel {",
           f"  static constexpr int kC = {c}, kR = {r_dim}, kCoef = {k_coef};",
           "  EPI_FN static constexpr int src(int r) {",
           "    switch (r) {"]
    out += [f"      case {r}: return {s};" for r, s in enumerate(src)]
    out += ["      default: return 0;", "    }", "  }",
            "  EPI_FN static void load(const float* th, int r, float* coef) {",
            "    switch (r) {"]
    for r, js in enumerate(reads):
        sets = " ".join(f"coef[{k}] = th[{j}];" for k, j in enumerate(js))
        out.append(f"      case {r}: {sets} break;" if sets else f"      case {r}: break;")
    out += ["      default: break;", "    }", "  }",
            "  EPI_FN static float rate(const float (&x)[kC], const float* coef, int r) {",
            "    switch (r) {"]
    for r, js in enumerate(reads):
        lines, result = _reaction_body(prog, r, {j: k for k, j in enumerate(js)})
        out.append(f"      case {r}: {{")
        out += [f"        {ln}" for ln in lines]
        out += [f"        return {result};", "      }"]
    out += ["      default: return 0.0f;", "    }", "  }",
            "  // the stoichiometry row by row, as epitpu_torch/sim/tauleap.py:substep",
            "  EPI_FN static void apply(float (&x)[kC], const float (&e)[kR]) {"]
    for r, row in enumerate(model.stoich.tolist()):
        for cc, s in enumerate(row):
            if s:
                out.append(f"    x[{cc}] = x[{cc}] + {_literal(s)} * e[{r}];")
    out += ["  }", "};", ""]
    return "\n".join(out)
