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
