"""Error handling: pluggable hooks + argument validation.

The counterpart of ``cholesky_tpu/utils/errors.py``: the reference's
``errorHandler`` hook becomes :func:`set_error_handler`, its LAPACK-style
``xerbla`` hook :func:`set_xerbla`. Invalid arguments raise at call time;
numerical failure (a non-positive pivot, a zero diagonal) is returned as
an ``info`` tensor, as LAPACK returns its info code.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional


def _default_error_handler(call: str, code: int, message: str,
                           function: str, location: str) -> None:
    print(f"error: {call} returned {code} ({message})\n"
          f"\tin {function} ({location})", file=sys.stderr)


def _default_xerbla(routine: str, arg: int, message: str = "") -> None:
    print(f" ** On entry to {routine.upper()} parameter number {arg} "
          f"had an illegal value{': ' + message if message else ''}",
          file=sys.stderr)


_error_handler: Optional[Callable] = _default_error_handler
_xerbla: Optional[Callable] = _default_xerbla


def set_error_handler(handler: Optional[Callable]) -> Optional[Callable]:
    """Install a runtime-error hook; returns the previous one. ``None``
    silences reporting."""
    global _error_handler
    prev, _error_handler = _error_handler, handler
    return prev


def set_xerbla(handler: Optional[Callable]) -> Optional[Callable]:
    """Install an invalid-argument hook; returns the previous one."""
    global _xerbla
    prev, _xerbla = _xerbla, handler
    return prev


def report_error(call: str, code: int, message: str, function: str,
                 location: str = "") -> None:
    if _error_handler is not None:
        _error_handler(call, code, message, function, location)


def xerbla(routine: str, arg: int, message: str = "") -> None:
    """Report an invalid argument through the hook and raise."""
    if _xerbla is not None:
        _xerbla(routine, arg, message)
    raise ValueError(
        f"{routine}: parameter {arg} had an illegal value"
        + (f": {message}" if message else ""))


def check(cond: bool, routine: str, arg: int, message="") -> None:
    """Validate an argument; on failure invoke xerbla and raise. ``message``
    is a string, or a callable that gives it, called only on failure (for
    checks on a path that runs thousands of times a call)."""
    if not cond:
        xerbla(routine, arg, message() if callable(message) else message)
