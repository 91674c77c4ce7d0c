"""Runtime type enforcement for public API functions.

The reference applies an equivalent decorator to all public entry points
(splink/check_types.py:20); we keep the behaviour (clear
TypeError naming the argument, Union-aware) for API parity.
"""

from __future__ import annotations

import inspect
import types
import typing
from functools import wraps


def _possible_types(hint):
    origin = typing.get_origin(hint)
    if origin is typing.Union or origin is types.UnionType:  # X | Y (PEP 604) too
        return tuple(t for t in typing.get_args(hint) if t is not type(None)) + (
            type(None),
        )
    if origin is not None:
        # Parameterised generics (dict[str, x], list[x], ...) -> check the origin only
        return (origin,)
    return (hint,)


def check_types(func):
    """Decorator that validates annotated arguments at call time."""
    sig = inspect.signature(func)
    hints = typing.get_type_hints(func)

    @wraps(func)
    def wrapper(*args, **kwargs):
        bound = sig.bind_partial(*args, **kwargs)
        for name, value in bound.arguments.items():
            if name not in hints or value is None:
                continue
            types = _possible_types(hints[name])
            try:
                ok = isinstance(value, types)
            except TypeError:
                continue  # unresolvable hint (e.g. Callable with params)
            if not ok:
                expected = " or ".join(str(t) for t in types)
                raise TypeError(
                    f"Wrong type for argument '{name}' of {func.__name__}: "
                    f"got {value!r} of type {type(value)}; expected {expected}."
                )
        return func(*args, **kwargs)

    return wrapper
