"""Framework core of the port: the Program IR, Scope, Executor, backward
and typed errors (counterparts of paddle_tpu/framework/*)."""
from . import unique_name
from .backward import append_backward
from .dtype import convert_dtype, dtype_name
from .executor import Executor
from .program import (Block, Operator, OpRole, Parameter, Program, Variable,
                      default_main_program, default_startup_program,
                      grad_var_name, program_guard)
from .scope import Scope, global_scope, load_numpy

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter", "OpRole",
    "program_guard", "default_main_program", "default_startup_program",
    "grad_var_name", "Executor", "Scope", "global_scope", "load_numpy",
    "append_backward", "convert_dtype", "dtype_name", "unique_name",
]
