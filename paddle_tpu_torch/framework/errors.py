"""Typed errors (the subset of paddle_tpu/framework/errors.py the serving
and training slices raise, the serving tier's timeouts and
unavailability, and the checkpoints' failed preconditions).

Each code is a distinct exception class carrying `.code`, and each also
subclasses the idiomatic Python builtin, so callers can catch either the
paddle type or the natural Python type.
"""
from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Mirrors platform/error_codes.proto."""
    LEGACY = 0
    INVALID_ARGUMENT = 1
    NOT_FOUND = 2
    PRECONDITION_NOT_MET = 6
    EXECUTION_TIMEOUT = 8
    UNIMPLEMENTED = 9
    UNAVAILABLE = 10


class EnforceNotMet(Exception):
    """Base paddle error. `.code` is the ErrorCode; `.op` / `.var` name the
    op/variable being processed when the raising site knows them."""
    code = ErrorCode.LEGACY

    def __init__(self, message: str, *, op: str | None = None,
                 var: str | None = None):
        self.op, self.var = op, var
        ctx = []
        if op:
            ctx.append(f"[operator < {op} > error]")
        if var:
            ctx.append(f"[variable < {var} >]")
        full = " ".join([message] + ctx) if ctx else message
        self.message = full
        super().__init__(full)

    def __str__(self):
        # KeyError-based subclasses would otherwise render via
        # repr(args[0]) — quotes and escapes around the message
        return self.message


def _typed(name, code_, base):
    return type(name, (EnforceNotMet, base),
                {"code": code_, "__doc__": f"ErrorCode.{code_.name}."})


InvalidArgumentError = _typed("InvalidArgumentError",
                              ErrorCode.INVALID_ARGUMENT, ValueError)
NotFoundError = _typed("NotFoundError", ErrorCode.NOT_FOUND, KeyError)
ExecutionTimeoutError = _typed("ExecutionTimeoutError",
                               ErrorCode.EXECUTION_TIMEOUT, TimeoutError)
PreconditionNotMetError = _typed("PreconditionNotMetError",
                                 ErrorCode.PRECONDITION_NOT_MET,
                                 RuntimeError)
UnimplementedError = _typed("UnimplementedError", ErrorCode.UNIMPLEMENTED,
                            NotImplementedError)
UnavailableError = _typed("UnavailableError", ErrorCode.UNAVAILABLE,
                          RuntimeError)


class DeadlineExceededError(ExecutionTimeoutError):
    """A retry budget (resilience.RetryPolicy) or an explicit deadline (the
    FLAGS_step_deadline_ms watchdog) was exhausted. Distinct from its
    ExecutionTimeoutError base so retry loops can tell "this op timed out
    once" from "the whole budget is spent"."""


def _factory(cls):
    def make(fmt, *args, op=None, var=None):
        return cls(fmt % args if args else fmt, op=op, var=var)
    make.__name__ = cls.code.name.title().replace("_", "")
    return make


# the reference's factory spellings: build (not raise) the typed error
InvalidArgument = _factory(InvalidArgumentError)
NotFound = _factory(NotFoundError)
PreconditionNotMet = _factory(PreconditionNotMetError)
Unimplemented = _factory(UnimplementedError)
Unavailable = _factory(UnavailableError)


def DeadlineExceeded(fmt, *args, op=None, var=None):
    """Build (not raise) a DeadlineExceededError, factory-style."""
    return DeadlineExceededError(fmt % args if args else fmt, op=op, var=var)
