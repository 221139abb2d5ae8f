"""SQL lexer.

Token stream for the recursive-descent parser (the role ANTLR's generated
lexer plays for SqlBase.g4 in the reference).  Keywords are recognized
case-insensitively; identifiers fold to lowercase, double-quoted included
(the reference's legacy canonicalization — `"YEAR"` resolves as "year").
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List


class SqlSyntaxError(ValueError):
    def __init__(self, message: str, line: int, col: int):
        super().__init__(f"line {line}:{col}: {message}")
        self.line = line
        self.col = col


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str      # IDENT QIDENT NUMBER STRING OP KEYWORD EOF
    text: str      # normalized: keywords/idents lowercased
    line: int
    col: int


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "escape",
    "is", "null", "true", "false", "case", "when", "then", "else", "end",
    "cast", "extract", "interval", "date", "time", "timestamp", "join",
    "inner", "left", "right", "full", "outer", "cross", "on", "asc",
    "desc", "nulls", "first", "last", "distinct", "all", "union", "except",
    "intersect", "with", "explain", "analyze", "show", "tables", "columns",
    "substring", "for", "coalesce", "nullif", "year", "month", "day",
    "hour", "minute", "second", "over", "partition", "rows", "range",
    "unbounded", "preceding", "following", "current", "row", "create",
    "table", "insert", "into", "drop", "values", "set", "reset", "session",
    "grouping", "sets", "rollup", "cube", "array", "unnest", "ordinality",
    "call",
}

_TWO_CHAR = ("<=", ">=", "<>", "!=", "||", "->")
_ONE_CHAR = "+-*/%(),.;<>=[]?"


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, line, col = 0, 1, 1
    n = len(sql)

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and sql[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            advance(1)
            continue
        if c == "-" and sql[i:i + 2] == "--":
            while i < n and sql[i] != "\n":
                advance(1)
            continue
        if c == "/" and sql[i:i + 2] == "/*":
            start_line, start_col = line, col
            advance(2)
            while i < n and sql[i:i + 2] != "*/":
                advance(1)
            if i >= n:
                raise SqlSyntaxError("unterminated comment", start_line,
                                     start_col)
            advance(2)
            continue
        if c == "'":
            start_line, start_col = line, col
            advance(1)
            buf = []
            while True:
                if i >= n:
                    raise SqlSyntaxError("unterminated string", start_line,
                                         start_col)
                if sql[i] == "'":
                    if sql[i + 1:i + 2] == "'":  # '' escape
                        buf.append("'")
                        advance(2)
                        continue
                    advance(1)
                    break
                buf.append(sql[i])
                advance(1)
            out.append(Token("STRING", "".join(buf), start_line, start_col))
            continue
        if c == '"':
            start_line, start_col = line, col
            advance(1)
            buf = []
            while i < n and sql[i] != '"':
                buf.append(sql[i])
                advance(1)
            if i >= n:
                raise SqlSyntaxError("unterminated quoted identifier",
                                     start_line, start_col)
            advance(1)
            # the reference canonicalizes ALL identifiers to lowercase,
            # quoted included (legacy Presto folding: `"YEAR"` == "year";
            # TPC-DS q66/q74 alias "YEAR" then reference "year")
            out.append(Token("QIDENT", "".join(buf).lower(),
                             start_line, start_col))
            continue
        if c.isdigit() or (c == "." and sql[i + 1:i + 2].isdigit()):
            start_line, start_col = line, col
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                        sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            text = sql[i:j]
            advance(j - i)
            out.append(Token("NUMBER", text, start_line, start_col))
            continue
        if c.isalpha() or c == "_":
            start_line, start_col = line, col
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j].lower()
            advance(j - i)
            kind = "KEYWORD" if word in KEYWORDS else "IDENT"
            out.append(Token(kind, word, start_line, start_col))
            continue
        two = sql[i:i + 2]
        if two in _TWO_CHAR:
            out.append(Token("OP", two, line, col))
            advance(2)
            continue
        if c in _ONE_CHAR:
            out.append(Token("OP", c, line, col))
            advance(1)
            continue
        raise SqlSyntaxError(f"unexpected character {c!r}", line, col)
    out.append(Token("EOF", "", line, col))
    return out
