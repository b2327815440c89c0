"""Static FLOP accounting by jaxpr traversal (roofline/MFU support).

``count_flops(fn, *args)`` traces ``fn`` (no compilation, no device)
and tallies arithmetic work primitive-by-primitive:

- elementwise arithmetic (add/mul/div/sqrt/exp/tanh/...) counts one
  flop per output element (transcendentals are reported separately in
  the breakdown so their true cost — several ops each — can be
  judged);
- ``dot_general`` counts ``2 * out_size * K`` (multiply-add);
- reductions count one flop per *input* element;
- the batched dense linear algebra counts the textbook estimates per
  (n, n) matrix: ``cholesky`` n^3/3, ``triangular_solve`` n^2 per
  right-hand-side column, ``eigh`` 9 n^3 (symmetric QR with
  eigenvectors, Golub & Van Loan §8.3);
- ``lax.scan`` bodies are counted once and multiplied by the trip
  count; ``cond`` takes the most expensive branch;
- ``pallas_call`` kernels are entered and counted like any other
  jaxpr.

The result is *logical* flops at the traced precision, with per-dtype
totals in the breakdown, so f64 and f32 work can each be placed against
their own peak rate.

No reference counterpart — the reference publishes no FLOP or
utilisation accounting (SURVEY.md §6).
"""
from typing import Any, Callable, Dict

import jax
import numpy as np

# one flop per output element
_ELEMENTWISE = {
    "add", "sub", "mul", "neg", "max", "min", "abs",
    "floor", "ceil", "round", "sign", "clamp",
    "add_any",
}
# costlier elementwise ops — still counted at 1 flop/element (lower
# bound), but split out in the breakdown
_TRANSCENDENTAL = {
    "div", "sqrt", "rsqrt", "exp", "exp2", "log", "log1p", "expm1",
    "tanh", "sin", "cos", "atan2", "pow", "integer_pow", "erf",
    "erfc", "erf_inv", "logistic", "cbrt", "lgamma", "digamma",
    "square",
}
_ZERO_COST = {
    "select_n", "eq", "ne", "lt", "le", "gt", "ge", "and", "or",
    "xor", "not", "convert_element_type", "bitcast_convert_type",
    "broadcast_in_dim", "reshape", "transpose", "squeeze", "rev",
    "slice", "dynamic_slice", "dynamic_update_slice", "concatenate",
    "gather", "scatter", "scatter-add", "iota", "pad", "copy",
    "stop_gradient", "is_finite", "reduce_and", "reduce_or",
    "reduce_max", "reduce_min", "argmax", "argmin", "sort",
    "shift_left", "shift_right_logical", "shift_right_arithmetic",
    "tile", "repeat", "roll",
    "rem", "device_put", "sharding_constraint", "split", "real",
    "imag", "complex", "expand_dims", "masked_swap", "masked_load",
    "masked_store", "get", "swap",
}
_CALL_PARAM_NAMES = ("jaxpr", "call_jaxpr", "fun_jaxpr", "cond_jaxpr")


def _aval_size(var) -> int:
    try:
        return int(np.prod(var.aval.shape)) if var.aval.shape else 1
    except Exception:
        return 1


def _dtype_of(var) -> str:
    try:
        return str(var.aval.dtype)
    except Exception:
        return "unknown"


def _enter(jaxpr_like):
    """Normalise ClosedJaxpr / Jaxpr to a Jaxpr."""
    return getattr(jaxpr_like, "jaxpr", jaxpr_like)


def _count_jaxpr(jaxpr, tally: Dict[str, float], mult: float = 1.0) -> None:
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        params = eqn.params

        if name == "scan":
            inner = params["jaxpr"]
            _count_jaxpr(_enter(inner), tally, mult * params["length"])
        elif name == "while":
            # trip count is data-dependent: count one iteration of the
            # body (a documented lower bound) and flag it
            _count_jaxpr(_enter(params["body_jaxpr"]), tally, mult)
            tally["__while_lower_bound__"] = 1.0
        elif name == "cond":
            # most expensive branch
            best: Dict[str, float] = {}
            for br in params["branches"]:
                sub: Dict[str, float] = {}
                _count_jaxpr(_enter(br), sub, mult)
                if sum(v for k, v in sub.items() if not k.startswith("__")) > sum(
                    v for k, v in best.items() if not k.startswith("__")
                ):
                    best = sub
            for k, v in best.items():
                tally[k] = tally.get(k, 0.0) + v
        elif name == "dot_general":
            dims = params["dimension_numbers"]
            (lhs_c, _), _ = dims
            lhs_shape = eqn.invars[0].aval.shape
            k = int(np.prod([lhs_shape[i] for i in lhs_c])) if lhs_c else 1
            out = _aval_size(eqn.outvars[0])
            key = f"dot_general[{_dtype_of(eqn.outvars[0])}]"
            tally[key] = tally.get(key, 0.0) + mult * 2.0 * out * k
        elif name in ("reduce_sum", "reduce_prod", "cumsum", "cumprod",
                      "cumlogsumexp", "cummax", "cummin"):
            size = _aval_size(eqn.invars[0])
            key = f"reduce[{_dtype_of(eqn.invars[0])}]"
            tally[key] = tally.get(key, 0.0) + mult * size
        elif name in _ELEMENTWISE or name in _TRANSCENDENTAL:
            out = _aval_size(eqn.outvars[0])
            bucket = "elementwise" if name in _ELEMENTWISE else "transcendental"
            key = f"{bucket}[{_dtype_of(eqn.outvars[0])}]"
            tally[key] = tally.get(key, 0.0) + mult * out
        elif name in ("cholesky", "eigh", "triangular_solve"):
            shape = eqn.invars[0].aval.shape
            n = shape[-1]
            mats = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            if name == "cholesky":
                per = n**3 / 3.0
            elif name == "eigh":
                per = 9.0 * n**3
            else:
                per = float(n * n * _aval_size(eqn.invars[1]) // (mats * n))
            key = f"linalg[{_dtype_of(eqn.invars[0])}]"
            tally[key] = tally.get(key, 0.0) + mult * mats * per
        elif name in _ZERO_COST:
            pass
        else:
            entered = False
            for pname in _CALL_PARAM_NAMES:
                if pname in params:
                    _count_jaxpr(_enter(params[pname]), tally, mult)
                    entered = True
                    break
            if not entered and "branches" in params:
                for br in params["branches"]:
                    _count_jaxpr(_enter(br), tally, mult)
                entered = True
            if not entered:
                tally[f"__unknown__{name}"] = tally.get(
                    f"__unknown__{name}", 0.0
                ) + 1.0


def count_flops(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, Any]:
    """Trace ``fn(*args, **kwargs)`` and tally its arithmetic work.

    Returns ``{"total": float, "f32": float, "f64": float,
    "breakdown": {key: flops}, "unknown_primitives": [...]}`` where
    f32/f64 split by the *traced* element dtype.
    """
    jaxpr = jax.make_jaxpr(fn)(*args, **kwargs)
    tally: Dict[str, float] = {}
    _count_jaxpr(jaxpr.jaxpr, tally)
    unknown = sorted(
        k.replace("__unknown__", "") for k in tally if k.startswith("__unknown__")
    )
    counted = {k: v for k, v in tally.items() if not k.startswith("__")}
    total = sum(counted.values())
    f32 = sum(v for k, v in counted.items() if "float32" in k)
    f64 = sum(v for k, v in counted.items() if "float64" in k)
    return {
        "total": total,
        "f32": f32,
        "f64": f64,
        "breakdown": {k: v for k, v in sorted(counted.items())},
        "unknown_primitives": unknown,
    }
