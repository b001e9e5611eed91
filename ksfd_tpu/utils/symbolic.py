"""Symbolic utilities: safe sympification and sympy->JAX compilation.

This module is the replacement for the reference's runtime C
code generator (KSFD/ksfdufunc.py:92-378): instead of emitting C99 and
dlopen'ing a numpy ufunc, we compile sympy expressions to JAX-traceable
callables with ``sympy.lambdify(modules='jax')`` and let XLA fuse and
compile them to device machine code.  There is no 32-argument ufunc limit,
so none of the reference's ufunc split/merge machinery
(KSFD/ksfdsym.py:1067-1156) is needed.

``safe_sympify`` mirrors KSFD/ksfdsym.py:55-79.
"""

import keyword
import re

import sympy as sy

from .exceptions import KSFDException

__all__ = ["safe_sympify", "jaxify", "free_parameter_names"]


#: Strings with non-expression meanings in the parameter language.
_LITERALS = {"": None, "True": True, "False": False}

_WORD_RE = re.compile(r"[A-Za-z_]\w*")


def safe_sympify(exp):
    """sympify() with a clear error on Python reserved keywords.

    Same user-facing semantics as the reference (KSFD/ksfdsym.py:55-79;
    independent implementation): '' -> None, 'False'/'True' -> bool,
    any string containing a Python keyword raises KSFDException
    (sympy would otherwise eval it as Python with confusing results).
    """
    if isinstance(exp, str):
        if exp in _LITERALS:
            return sy.sympify(_LITERALS[exp])
        reserved = sorted(
            {w for w in _WORD_RE.findall(exp) if keyword.iskeyword(w)}
        )
        if reserved:
            raise KSFDException(
                "expression contains Python keyword %r: %r"
                % (reserved[0], exp)
            )
    return sy.sympify(exp)


def jaxify(args, expr, name=None):
    """Compile a sympy expression (or list of them) to a JAX callable.

    Parameters
    ----------
    args : sequence of sympy Symbols — the positional arguments.
    expr : sympy expression or list of expressions.
    name : optional name (used for the generated function's __name__).

    Returns a function of ``len(args)`` JAX arrays/scalars.  The result
    is traceable: call it inside ``jax.jit`` for fused compilation.
    """
    fn = sy.lambdify(tuple(args), expr, modules="jax")
    if name:
        try:
            fn.__name__ = name
        except (AttributeError, TypeError):
            pass
    return fn


def free_parameter_names(expr, exclude=("x", "y", "z", "t")):
    """Sorted names of free symbols in ``expr`` excluding coordinates."""
    expr = safe_sympify(expr)
    if expr is None or isinstance(expr, bool):
        return []
    try:
        syms = expr.free_symbols
    except AttributeError:
        return []
    return sorted(str(s) for s in syms if str(s) not in exclude)
