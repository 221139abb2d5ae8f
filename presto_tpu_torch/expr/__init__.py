"""Expression engine: RowExpression IR -> evaluation over numpy (host)
or torch (device) through one compiler (``compile.py`` over the
namespaces of ``xp.py``).  Replaces the reference's runtime-bytecode
tier (presto-main/.../sql/gen/ExpressionCompiler.java:55)."""

from presto_tpu_torch.expr.ir import (  # noqa: F401
    Call, Constant, InputRef, RowExpression, SpecialForm,
)
