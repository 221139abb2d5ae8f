"""SQL front end: lexer -> parser -> AST -> analyzer -> logical plan.

The reference parses with an ANTLR4 grammar
(presto-parser/src/main/antlr4/io/prestosql/sql/parser/SqlBase.g4, 819
lines) into ~170 AST node classes, analyzes them
(presto-main/.../sql/analyzer/StatementAnalyzer.java:243), and plans into a
PlanNode tree (presto-main/.../sql/planner/LogicalPlanner.java:176).  This
package is the same pipeline built fresh: a hand-written recursive-descent
parser over the SQL subset the engine executes (the full TPC-H/TPC-DS
query shape), a scope-based analyzer, and a logical planner producing the
PlanNode IR in ``plan.py``.
"""

from presto_tpu_torch.sql.parser import parse_statement  # noqa: F401
