"""Evaluate a JAX program one primitive at a time.

XLA's CPU compiler contracts ``a*b+c`` into an FMA inside any program it
compiles as a whole: a jitted function, or a Pallas kernel in interpret
mode, which JAX always compiles as one program (``pallas_call``'s
implementation re-enters ``jit``, even under ``jax.disable_jit()``). To
see what JAX's own op sequence gives with every multiply and add rounded
on its own, :func:`eval_closed` walks the program's jaxpr and dispatches
each primitive by itself, recursing into ``jit`` calls, loops,
conditionals and the Pallas interpreter's own jaxpr. A program evaluated
so runs slowly (seconds for a small ray bundle) but rounds like the
port's plain PyTorch versions.

:func:`numpy_op_by_op` walks a program the same way but computes each
elementwise, shape, reduction and gather primitive with NumPy, which
rounds every float operation on its own as a primitive compiled alone
does, and binds the rest (control flow, anything without a rule) in JAX.
Dispatching a primitive to XLA alone costs far more than the NumPy call
on arrays of a few thousand elements, so a host loop of many small
programs (the v1 tracer) runs in seconds instead of minutes.
"""

import jax
import numpy as np
from jax._src import core as score
from jax._src.pallas import hlo_interpreter


def _read(env, v):
    if isinstance(v, score.Literal):
        return v.val
    return env[v]


def eval_jaxpr(jaxpr, consts, *args):
    """Values of ``jaxpr``'s outputs, each equation applied alone."""
    env = {}
    for v, c in zip(jaxpr.constvars, consts):
        env[v] = c
    for v, a in zip(jaxpr.invars, args):
        env[v] = a
    for eqn in jaxpr.eqns:
        ins = [_read(env, v) for v in eqn.invars]
        outs = apply(eqn, ins)
        if not eqn.primitive.multiple_results and not isinstance(outs, (list, tuple)):
            outs = [outs]
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
    return [_read(env, v) for v in jaxpr.outvars]


def eval_closed(cj, *args):
    """:func:`eval_jaxpr` of a ``ClosedJaxpr`` (``jax.make_jaxpr``'s)."""
    return eval_jaxpr(cj.jaxpr, cj.consts, *args)


def apply(eqn, ins):
    """One equation: control flow and calls recurse, the rest bind one
    primitive (compiled alone, it has nothing to contract with)."""
    p, prm = eqn.primitive.name, eqn.params
    if p in ("pjit", "jit", "closed_call", "core_call"):
        j = prm.get("jaxpr") or prm.get("call_jaxpr")
        return eval_closed(j, *ins) if hasattr(j, "consts") else eval_jaxpr(j, (), *ins)
    if p in ("custom_jvp_call", "custom_vjp_call", "custom_vjp_call_jaxpr"):
        j = prm.get("call_jaxpr") or prm.get("fun_jaxpr")
        return eval_closed(j, *ins)
    if p in ("remat", "checkpoint"):
        return eval_jaxpr(prm["jaxpr"], (), *ins)
    if p == "while":
        cn, bn = prm["cond_nconsts"], prm["body_nconsts"]
        cc, bc, carry = ins[:cn], ins[cn:cn + bn], list(ins[cn + bn:])
        while bool(np.asarray(eval_closed(prm["cond_jaxpr"], *cc, *carry)[0])):
            carry = eval_closed(prm["body_jaxpr"], *bc, *carry)
        return carry
    if p == "scan":
        nc, ncar = prm["num_consts"], prm["num_carry"]
        consts, carry, xs = ins[:nc], list(ins[nc:nc + ncar]), ins[nc + ncar:]
        n, ys = prm["length"], []
        idx = range(n - 1, -1, -1) if prm["reverse"] else range(n)
        for i in idx:
            out = eval_closed(prm["jaxpr"], *consts, *carry, *[x[i] for x in xs])
            carry, y = out[:ncar], out[ncar:]
            ys.append(y)
        if prm["reverse"]:
            ys = ys[::-1]
        nys = len(prm["jaxpr"].jaxpr.outvars) - ncar
        stacked = [jax.numpy.stack([y[k] for y in ys]) for k in range(nys)]
        return carry + stacked
    if p == "cond":
        i = int(np.asarray(ins[0]))
        br = prm["branches"]
        i = min(max(i, 0), len(br) - 1)
        return eval_closed(br[i], *ins[1:])
    if p == "pallas_call":
        kw = {k: v for k, v in prm.items() if k not in ("interpret", "backend")}

        def interpret(*a):
            return hlo_interpreter.pallas_call_hlo_interpret(
                *a, backend=None, **kw)

        cj = jax.make_jaxpr(interpret)(*ins)
        return eval_closed(cj, *ins)
    return eqn.primitive.bind(*ins, **prm)


def _convert(eqn):
    """XLA's convert_element_type: float -> int saturates, NaN -> 0."""
    src = np.dtype(eqn.invars[0].aval.dtype)
    new = np.dtype(eqn.params["new_dtype"])
    if new == np.bool_:
        return lambda x: np.not_equal(x, 0)
    if new.kind in "iu" and src.kind == "f":
        info = np.iinfo(new)

        def f(x):
            x = np.asarray(x)
            if x.size and np.abs(x).max() < 2.0 ** (info.bits - 1):
                return x.astype(new)
            y = np.where(np.isnan(x), 0, np.clip(x, info.min, info.max))
            return y.astype(new)
        return f
    return lambda x: np.asarray(x).astype(new)


def _shift(kind):
    """XLA's shifts: a count outside [0, bits) gives 0 (the sign for an
    arithmetic right shift)."""
    def make(eqn):
        dt = np.dtype(eqn.invars[0].aval.dtype)
        bits = dt.itemsize * 8
        udt = np.dtype(f"u{dt.itemsize}")

        def shift(x, s):
            if kind == "left":
                return np.left_shift(x, s)
            if kind == "arith":
                return np.right_shift(x, s)
            return np.right_shift(np.asarray(x).view(udt),
                                  np.asarray(s).view(udt)).view(dt)

        def f(x, s):
            x, s = np.asarray(x), np.asarray(s)
            ok = (s >= 0) & (s < bits)
            if ok.all():
                return shift(x, s)
            out = shift(x, np.where(ok, s, 0).astype(dt))
            fill = np.right_shift(x, bits - 1) if kind == "arith" else 0
            return np.where(ok, out, fill).astype(dt)
        return f
    return make


def _gather(eqn):
    """XLA's gather, index vectors on the last axis of the indices; out of
    range starts are clamped, or filled in ``FILL_OR_DROP`` mode."""
    prm = eqn.params
    dn = prm["dimension_numbers"]
    sizes = prm["slice_sizes"]
    op_shape = eqn.invars[0].aval.shape
    out_rank = len(eqn.outvars[0].aval.shape)
    fill_mode = "FILL" in str(prm["mode"])
    fill = prm["fill_value"]
    if fill_mode and fill is None:
        return None  # the dtype's default fill: bound in JAX
    dropped = set(dn.collapsed_slice_dims) | set(dn.operand_batching_dims)
    kept = [d for d in range(len(op_shape)) if d not in dropped]
    batch_pos = [p for p in range(out_rank) if p not in dn.offset_dims]

    def f(operand, indices):
        operand, indices = np.asarray(operand), np.asarray(indices)
        bshape = indices.shape[:-1]
        nb, nd = len(bshape), len(op_shape)
        oob = np.zeros(bshape, bool)
        index = []
        for d in range(nd):
            if d in dn.start_index_map:
                start = indices[..., dn.start_index_map.index(d)].astype(
                    np.int64)
                hi = op_shape[d] - sizes[d]
                oob |= (start < 0) | (start > hi)
                start = np.clip(start, 0, hi)
            elif d in dn.operand_batching_dims:
                bd = dn.start_indices_batching_dims[
                    dn.operand_batching_dims.index(d)]
                start = np.arange(bshape[bd]).reshape(
                    [-1 if k == bd else 1 for k in range(nb)])
            else:
                start = np.zeros((1,) * nb, np.int64)
            step = np.arange(sizes[d]).reshape(
                [-1 if k == d else 1 for k in range(nd)])
            index.append(start.reshape(start.shape + (1,) * nd) + step)
        out = operand[tuple(index)]  # bshape + slice_sizes
        out = out.reshape(bshape + tuple(sizes[d] for d in kept))
        if fill_mode and oob.any():
            out = np.where(oob.reshape(oob.shape + (1,) * len(kept)),
                           np.asarray(fill).astype(out.dtype), out)
        # batch axes to the output's batch positions, slice axes to
        # offset_dims
        src = list(range(nb, nb + len(kept))) + list(range(nb))
        dst = list(dn.offset_dims) + batch_pos
        perm = [0] * out_rank
        for a, b in zip(src, dst):
            perm[b] = a
        return np.transpose(out, perm)
    return f


def _broadcast_in_dim(eqn):
    shape = eqn.params["shape"]
    dt = np.dtype(eqn.outvars[0].aval.dtype)
    view = [1] * len(shape)
    for d, n in zip(eqn.params["broadcast_dimensions"],
                    eqn.invars[0].aval.shape):
        view[d] = n

    def f(x):
        out = np.empty(shape, dt)
        out[...] = np.asarray(x).reshape(view)
        return out
    return f


def _iota(eqn):
    prm = eqn.params
    shape, dim = prm["shape"], prm["dimension"]
    view = [1] * len(shape)
    view[dim] = shape[dim]
    out = np.broadcast_to(
        np.arange(shape[dim], dtype=prm["dtype"]).reshape(view), shape).copy()
    return lambda: out


def _select_n(eqn):
    if len(eqn.invars) != 3:
        return None  # more than two cases: bound in JAX
    return lambda which, a, b: np.where(which, b, a)


def _div(eqn):
    if np.dtype(eqn.invars[0].aval.dtype).kind in "iu":
        return None  # XLA's truncating division: bound in JAX
    return np.divide


def _with(f, *names):
    """A rule calling ``f(*inputs, **params)`` for the named params."""
    return lambda eqn: (lambda *x: f(*x, **{k: eqn.params[k] for k in names}))


def _slice(x, start_indices, limit_indices, strides):
    strides = strides or (1,) * len(start_indices)
    return np.asarray(x)[tuple(slice(a, b, c) for a, b, c in zip(
        start_indices, limit_indices, strides))]


# primitive name -> rule: eqn -> f(*inputs) in NumPy (None: bind in JAX)
NUMPY_RULES = {
    **{name: (lambda f: lambda eqn: f)(f) for name, f in (
        ("add", np.add), ("sub", np.subtract), ("mul", np.multiply),
        ("neg", np.negative), ("abs", np.abs), ("sign", np.sign),
        ("floor", np.floor), ("ceil", np.ceil), ("max", np.maximum),
        ("min", np.minimum), ("eq", np.equal), ("ne", np.not_equal),
        ("lt", np.less), ("le", np.less_equal), ("gt", np.greater),
        ("ge", np.greater_equal), ("and", np.bitwise_and),
        ("or", np.bitwise_or), ("not", np.invert))},
    "div": _div,
    "shift_left": _shift("left"),
    "shift_right_arithmetic": _shift("arith"),
    "shift_right_logical": _shift("logical"),
    "convert_element_type": _convert,
    "select_n": _select_n,
    "broadcast_in_dim": _broadcast_in_dim,
    "iota": _iota,
    "reshape": _with(lambda x, new_sizes: np.reshape(x, new_sizes),
                     "new_sizes"),
    "transpose": _with(lambda x, permutation: np.transpose(x, permutation),
                       "permutation"),
    "squeeze": _with(lambda x, dimensions: np.squeeze(
        x, axis=tuple(dimensions)), "dimensions"),
    "slice": _with(_slice, "start_indices", "limit_indices", "strides"),
    "concatenate": _with(lambda *xs, dimension: np.concatenate(
        xs, axis=dimension), "dimension"),
    "reduce_and": _with(lambda x, axes: np.all(x, axis=tuple(axes)), "axes"),
    "reduce_or": _with(lambda x, axes: np.any(x, axis=tuple(axes)), "axes"),
    "reduce_sum": _with(lambda x, axes: np.sum(
        x, axis=tuple(axes), dtype=np.asarray(x).dtype), "axes"),
    "gather": _gather,
    "argmax": _with(lambda x, axes, index_dtype: np.argmax(
        x, axis=axes[0]).astype(index_dtype), "axes", "index_dtype"),
}


class _Program:
    """A jaxpr flattened for :func:`numpy_op_by_op`: nested ``jit`` calls
    inlined, every variable a slot of one list, literals and constants
    filled in once, each equation a NumPy rule (or a JAX bind)."""

    def __init__(self, cj):
        self.init = []
        self.steps = []
        slot = {}
        self.ins = [self._new(slot, v) for v in cj.jaxpr.invars]
        self.outs = self._inline(cj.jaxpr, cj.consts, self.ins, slot)

    def _new(self, slot, v):
        slot[v] = len(self.init)
        self.init.append(None)
        return slot[v]

    def _const(self, value):
        self.init.append(value)
        return len(self.init) - 1

    def _inline(self, jaxpr, consts, in_slots, slot):
        def read(v):
            if isinstance(v, score.Literal):
                return self._const(np.asarray(v.val, dtype=v.aval.dtype))
            return slot[v]

        for v, c in zip(jaxpr.constvars, consts):
            slot[v] = self._const(np.asarray(c))
        for v, i in zip(jaxpr.invars, in_slots):
            slot[v] = i
        for eqn in jaxpr.eqns:
            ins = tuple(read(v) for v in eqn.invars)
            name, prm = eqn.primitive.name, eqn.params
            if name in ("pjit", "jit"):
                inner = prm["jaxpr"]
                outs = self._inline(inner.jaxpr, inner.consts, ins, {})
                for v, o in zip(eqn.outvars, outs):
                    slot[v] = o
                continue
            rule = NUMPY_RULES.get(name)
            f = rule(eqn) if rule is not None else None
            fn = _bound(eqn) if f is None else _ruled(f)
            outs = tuple(self._new(slot, v) for v in eqn.outvars)
            self.steps.append((fn, ins, outs,
                               tuple(np.dtype(v.aval.dtype)
                                     for v in eqn.outvars)))
        return [read(v) for v in jaxpr.outvars]

    def __call__(self, args):
        env = list(self.init)
        for i, a in zip(self.ins, args):
            env[i] = a
        for fn, ins, outs, dts in self.steps:
            res = fn(*[env[i] for i in ins])
            for o, r, dt in zip(outs, res, dts):
                if getattr(r, "dtype", None) != dt:
                    r = np.asarray(r, dtype=dt)
                env[o] = r
        return [env[i] for i in self.outs]


def _ruled(f):
    def fn(*ins):
        return (f(*ins),)
    return fn


def _bound(eqn):
    def fn(*ins):
        outs = apply(eqn, ins)
        outs = outs if eqn.primitive.multiple_results else [outs]
        return [np.asarray(o) for o in outs]
    return fn


def numpy_op_by_op(fn):
    """``fn`` (a JAX function; keywords are static) evaluated one primitive
    at a time, mostly in NumPy (module docstring). Takes and returns
    pytrees; the leaves it returns are NumPy arrays. Each argument
    structure, shape and keyword set is traced once."""
    traced = {}

    def run(*args, **kw):
        flat, tree = jax.tree_util.tree_flatten(args)
        flat = [np.asarray(x) for x in flat]
        key = (tree, tuple(sorted(kw.items())),
               tuple((x.shape, x.dtype) for x in flat))
        if key not in traced:
            def g(*leaves):
                return fn(*jax.tree_util.tree_unflatten(tree, leaves), **kw)

            cj, shape = jax.make_jaxpr(g, return_shape=True)(*flat)
            traced[key] = _Program(cj), jax.tree_util.tree_structure(shape)
        prog, out_tree = traced[key]
        return jax.tree_util.tree_unflatten(out_tree, prog(flat))

    return run
