"""Recursive-descent SQL parser.

Covers the query shape of SqlBase.g4 that the engine executes: SELECT
[DISTINCT] items FROM relations (comma / JOIN ... ON) WHERE ... GROUP BY
... HAVING ... ORDER BY ... LIMIT n, WITH ctes, subqueries (FROM,
IN/EXISTS/scalar), CASE, CAST, EXTRACT, BETWEEN, LIKE, interval & typed
literals, EXPLAIN, SHOW TABLES/COLUMNS.  Operator precedence mirrors the
reference grammar: OR < AND < NOT < predicate < additive < multiplicative
< unary < primary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from presto_tpu_torch.sql import tree as t
from presto_tpu_torch.sql.lexer import SqlSyntaxError, Token, tokenize


def parse_statement(sql: str) -> t.Node:
    return _Parser(tokenize(sql), sql).parse_statement()


def parse_expression(sql: str) -> t.Expression:
    p = _Parser(tokenize(sql))
    e = p.expression()
    p.expect_eof()
    return e


class _Parser:
    def __init__(self, tokens: List[Token], sql: str = ""):
        self.toks = tokens
        self.pos = 0
        self.sql = sql
        self._param_seq = 0

    # --- token helpers -----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        tok = self.toks[self.pos]
        if tok.kind != "EOF":
            self.pos += 1
        return tok

    def at_kw(self, *words: str) -> bool:
        tok = self.peek()
        return tok.kind == "KEYWORD" and tok.text in words

    def at_op(self, *ops: str) -> bool:
        tok = self.peek()
        return tok.kind == "OP" and tok.text in ops

    def accept_kw(self, *words: str) -> Optional[str]:
        if self.at_kw(*words):
            return self.next().text
        return None

    def accept_op(self, *ops: str) -> Optional[str]:
        if self.at_op(*ops):
            return self.next().text
        return None

    def expect_kw(self, word: str) -> None:
        tok = self.next()
        if tok.kind != "KEYWORD" or tok.text != word:
            raise SqlSyntaxError(f"expected {word.upper()}, found "
                                 f"{tok.text or 'end of input'!r}",
                                 tok.line, tok.col)

    def expect_op(self, op: str) -> None:
        tok = self.next()
        if tok.kind != "OP" or tok.text != op:
            raise SqlSyntaxError(f"expected {op!r}, found "
                                 f"{tok.text or 'end of input'!r}",
                                 tok.line, tok.col)

    # Soft (context-sensitive) keywords: words like DELETE/PREPARE/USE are
    # only keywords in statement position; the lexer tokenizes them as
    # IDENT, so these helpers match by text regardless of token kind
    # (SqlBase.g4's nonReserved rule plays the same role).
    def at_word(self, *words: str) -> bool:
        tok = self.peek()
        return tok.kind in ("KEYWORD", "IDENT") and tok.text in words

    def at_word_seq(self, *words: str) -> bool:
        for k, w in enumerate(words):
            tok = self.peek(k)
            if tok.kind not in ("KEYWORD", "IDENT") or tok.text != w:
                return False
        return True

    def accept_word(self, *words: str) -> Optional[str]:
        if self.at_word(*words):
            return self.next().text
        return None

    def expect_word(self, word: str) -> None:
        tok = self.next()
        if tok.kind not in ("KEYWORD", "IDENT") or tok.text != word:
            raise SqlSyntaxError(f"expected {word.upper()}, found "
                                 f"{tok.text or 'end of input'!r}",
                                 tok.line, tok.col)

    def expect_eof(self) -> None:
        tok = self.peek()
        if tok.kind != "EOF":
            raise SqlSyntaxError(f"unexpected {tok.text!r}", tok.line,
                                 tok.col)

    def identifier(self) -> str:
        tok = self.next()
        if tok.kind in ("IDENT", "QIDENT"):
            return tok.text
        # non-reserved keywords usable as identifiers
        if tok.kind == "KEYWORD" and tok.text in (
                "year", "month", "day", "hour", "minute", "second", "date",
                "time", "first", "last", "tables", "columns", "show"):
            return tok.text
        raise SqlSyntaxError(f"expected identifier, found "
                             f"{tok.text or 'end of input'!r}",
                             tok.line, tok.col)

    def qualified_name(self) -> Tuple[str, ...]:
        parts = [self.identifier()]
        while self.at_op("."):
            self.next()
            parts.append(self.identifier())
        return tuple(parts)

    # --- statements --------------------------------------------------------
    def parse_statement(self) -> t.Node:
        if self.accept_kw("call"):
            name = self.qualified_name()
            self.expect_op("(")
            args: List[t.Expression] = []
            if not self.at_op(")"):
                args.append(self.expression())
                while self.accept_op(","):
                    args.append(self.expression())
            self.expect_op(")")
            self.accept_op(";")
            self.expect_eof()
            return t.CallProcedure(name, tuple(args))
        if self.accept_kw("explain"):
            plan_type = "logical"
            if self.at_op("(") and self.peek(1).text == "type":
                self.next()
                self.expect_word("type")
                tok = self.next()
                if tok.text not in ("logical", "distributed", "validate",
                                    "io"):
                    raise SqlSyntaxError(
                        f"unknown EXPLAIN type {tok.text!r}",
                        tok.line, tok.col)
                plan_type = tok.text
                self.expect_op(")")
            analyze = bool(self.accept_kw("analyze"))
            inner = self.parse_statement()
            return t.Explain(inner, analyze, plan_type)
        if self.accept_kw("create"):
            replace = False
            if self.accept_kw("or"):
                self.expect_word("replace")
                replace = True
            if self.accept_word("view"):
                name = self.qualified_name()
                self.expect_kw("as")
                start = self.pos
                q = self.query()
                node: t.Node = t.CreateView(
                    name, q, replace,
                    original_sql=self._text_between(start, self.pos))
                self.accept_op(";")
                self.expect_eof()
                return node
            if replace:
                raise SqlSyntaxError("OR REPLACE only applies to views",
                                     self.peek().line, self.peek().col)
            self.expect_kw("table")
            if_not_exists = False
            if self.accept_word("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            name = self.qualified_name()
            if self.accept_kw("as"):
                node = t.CreateTableAs(name, self.query(), if_not_exists)
            elif self.at_kw("with"):
                node = t.CreateTableAs(
                    name, None, if_not_exists,      # query filled below
                    self.table_properties())
                self.expect_kw("as")
                node = dataclasses.replace(node, query=self.query())
            else:
                self.expect_op("(")
                cols = [(self.identifier(), self.type_name())]
                while self.accept_op(","):
                    cols.append((self.identifier(), self.type_name()))
                self.expect_op(")")
                props = self.table_properties() if self.at_kw("with") \
                    else ()
                node = t.CreateTable(name, tuple(cols), if_not_exists,
                                     props)
            self.accept_op(";")
            self.expect_eof()
            return node
        if self.accept_kw("insert"):
            self.expect_kw("into")
            name = self.qualified_name()
            cols: Tuple[str, ...] = ()
            if self.at_op("(") and not (
                    self.peek(1).kind == "KEYWORD"
                    and self.peek(1).text in ("select", "with", "values")):
                self.next()
                names = [self.identifier()]
                while self.accept_op(","):
                    names.append(self.identifier())
                self.expect_op(")")
                cols = tuple(names)
            if self.at_kw("values"):
                source: t.Node = self.inline_values()
            else:
                source = self.query()
            self.accept_op(";")
            self.expect_eof()
            return t.Insert(name, cols, source)
        if self.accept_kw("drop"):
            is_view = bool(self.accept_word("view"))
            if not is_view:
                self.expect_kw("table")
            if_exists = False
            if self.accept_word("if"):
                self.expect_kw("exists")
                if_exists = True
            name = self.qualified_name()
            self.accept_op(";")
            self.expect_eof()
            return (t.DropView(name, if_exists) if is_view
                    else t.DropTable(name, if_exists))
        if self.accept_word("delete"):
            self.expect_kw("from")
            name = self.qualified_name()
            where = self.expression() if self.accept_kw("where") else None
            self.accept_op(";")
            self.expect_eof()
            return t.Delete(name, where)
        if self.accept_word("alter"):
            self.expect_kw("table")
            name = self.qualified_name()
            self.expect_word("rename")
            self.expect_word("to")
            new_name = self.qualified_name()
            self.accept_op(";")
            self.expect_eof()
            return t.RenameTable(name, new_name)
        if self.accept_word("prepare"):
            name = self.identifier()
            self.expect_kw("from")
            start = self.pos
            inner = self.parse_statement()
            return t.Prepare(name, inner,
                             self._text_between(start, len(self.toks)))
        if (self.at_word("execute")
                and self.peek(1).kind in ("IDENT", "QIDENT")):
            self.next()
            name = self.identifier()
            params: List[t.Expression] = []
            if self.accept_word("using"):
                params.append(self.expression())
                while self.accept_op(","):
                    params.append(self.expression())
            self.accept_op(";")
            self.expect_eof()
            return t.ExecutePrepared(name, tuple(params))
        if self.accept_word("deallocate"):
            self.expect_word("prepare")
            name = self.identifier()
            self.accept_op(";")
            self.expect_eof()
            return t.Deallocate(name)
        if self.accept_word("describe"):
            if self.accept_word("input"):
                node = t.DescribeInput(self.identifier())
            elif self.accept_word("output"):
                node = t.DescribeOutput(self.identifier())
            else:
                node = t.ShowColumns(self.qualified_name())
            self.accept_op(";")
            self.expect_eof()
            return node
        if self.accept_word("use"):
            parts = self.qualified_name()
            if len(parts) > 2:
                raise SqlSyntaxError("USE catalog[.schema]",
                                     self.peek().line, self.peek().col)
            self.accept_op(";")
            self.expect_eof()
            return t.Use(parts[0], parts[1] if len(parts) > 1 else None)
        if self.at_word("start"):
            self.next()
            self.expect_word("transaction")
            self.accept_op(";")
            self.expect_eof()
            return t.StartTransaction()
        if self.accept_word("commit"):
            self.accept_word("work")
            self.accept_op(";")
            self.expect_eof()
            return t.Commit()
        if self.accept_word("rollback"):
            self.accept_word("work")
            self.accept_op(";")
            self.expect_eof()
            return t.Rollback()
        if self.at_kw("analyze"):
            self.next()
            name = self.qualified_name()
            self.accept_op(";")
            self.expect_eof()
            return t.Analyze(name)
        if self.at_word("grant") or self.at_word("revoke"):
            is_grant = self.next().text == "grant"
            privs = [self.privilege()]
            while self.accept_op(","):
                privs.append(self.privilege())
            self.expect_kw("on")
            self.accept_kw("table")
            name = self.qualified_name()
            self.expect_word("to" if is_grant else "from")
            grantee = self.identifier()
            self.accept_op(";")
            self.expect_eof()
            return (t.Grant(tuple(privs), name, grantee) if is_grant
                    else t.Revoke(tuple(privs), name, grantee))
        if self.accept_kw("set"):
            self.expect_kw("session")
            name = ".".join(self.qualified_name())
            self.expect_op("=")
            tok = self.next()
            if tok.kind not in ("STRING", "NUMBER", "KEYWORD", "IDENT"):
                raise SqlSyntaxError("expected session property value",
                                     tok.line, tok.col)
            self.accept_op(";")
            self.expect_eof()
            return t.SetSession(name, tok.text)
        if self.accept_kw("reset"):
            self.expect_kw("session")
            name = ".".join(self.qualified_name())
            self.accept_op(";")
            self.expect_eof()
            return t.ResetSession(name)
        if self.accept_kw("show"):
            if self.accept_kw("tables"):
                cat = None
                if self.accept_kw("from") or self.accept_kw("in"):
                    cat = self.identifier()
                node: t.Node = t.ShowTables(cat, self._opt_like())
            elif self.accept_kw("session"):
                node = t.ShowSession()
            elif self.accept_word("catalogs"):
                node = t.ShowCatalogs(self._opt_like())
            elif self.accept_word("schemas"):
                cat = None
                if self.accept_kw("from") or self.accept_kw("in"):
                    cat = self.identifier()
                node = t.ShowSchemas(cat, self._opt_like())
            elif self.accept_word("functions"):
                node = t.ShowFunctions(self._opt_like())
            elif self.accept_word("stats"):
                self.expect_kw("for")
                node = t.ShowStats(self.qualified_name())
            elif self.accept_kw("create"):
                if self.accept_word("view"):
                    node = t.ShowCreateView(self.qualified_name())
                else:
                    self.expect_kw("table")
                    node = t.ShowCreateTable(self.qualified_name())
            else:
                self.expect_kw("columns")
                self.expect_kw("from")
                node = t.ShowColumns(self.qualified_name())
            self.accept_op(";")
            self.expect_eof()
            return node
        q = self.query()
        self.accept_op(";")
        self.expect_eof()
        return q

    def query(self) -> t.Node:
        with_queries: List[Tuple[str, t.Query]] = []
        if self.accept_kw("with"):
            while True:
                name = self.identifier()
                self.expect_kw("as")
                self.expect_op("(")
                with_queries.append((name, self.query()))
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        body = self.query_expr()
        if isinstance(body, t.Query):
            return dataclasses.replace(
                body, with_queries=tuple(with_queries))
        return t.SetOperation(body.op, body.all, body.left, body.right,
                              body.order_by, body.limit, tuple(with_queries))

    def query_expr(self) -> t.Node:
        """query_term (UNION|EXCEPT [ALL] query_term)* [ORDER BY] [LIMIT];
        INTERSECT binds tighter than UNION/EXCEPT (SqlBase.g4 precedence)."""
        node = self.query_term()
        while self.at_kw("union", "except"):
            op = self.next().text
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            node = t.SetOperation(op, all_, node, self.query_term())
        order_by, limit = self._order_limit()
        if order_by or limit is not None:
            if isinstance(node, t.SetOperation):
                node = t.SetOperation(node.op, node.all, node.left,
                                      node.right, order_by, limit)
            else:
                node = dataclasses.replace(node, order_by=order_by,
                                           limit=limit)
        return node

    def query_term(self) -> t.Node:
        node = self.query_primary()
        while self.at_kw("intersect"):
            self.next()
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            node = t.SetOperation("intersect", all_, node,
                                  self.query_primary())
        return node

    def query_primary(self) -> t.Node:
        if self.at_op("(") and self.peek(1).kind == "KEYWORD" \
                and self.peek(1).text in ("select", "with", "("):
            self.next()
            q = self.query()
            self.expect_op(")")
            return q
        return self.query_body()

    def _order_limit(self):
        order_by: List[t.SortItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.sort_item())
            while self.accept_op(","):
                order_by.append(self.sort_item())
        limit = None
        if self.accept_kw("limit"):
            tok = self.next()
            if tok.kind != "NUMBER":
                raise SqlSyntaxError("expected LIMIT count", tok.line,
                                     tok.col)
            limit = int(tok.text)
        return tuple(order_by), limit

    def query_body(self) -> t.Query:
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        self.accept_kw("all")
        select = [self.select_item()]
        while self.accept_op(","):
            select.append(self.select_item())

        relations: List[t.Relation] = []
        if self.accept_kw("from"):
            relations.append(self.relation())
            while self.accept_op(","):
                relations.append(self.relation())

        where = self.expression() if self.accept_kw("where") else None

        group_by: List[t.Expression] = []
        grouping_sets = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            if self.at_kw("grouping", "rollup", "cube"):
                group_by, grouping_sets = self.grouping_element()
            else:
                group_by.append(self.expression())
                while self.accept_op(","):
                    group_by.append(self.expression())

        having = self.expression() if self.accept_kw("having") else None
        # ORDER BY / LIMIT are parsed by query_expr so they attach to the
        # whole set operation when UNION/INTERSECT/EXCEPT follows.
        return t.Query(tuple(select), tuple(relations), where,
                       tuple(group_by), having, (), None, distinct,
                       grouping_sets=grouping_sets)

    def grouping_element(self):
        """ROLLUP(a, b) / CUBE(a, b) / GROUPING SETS ((a,b),(a),()) ->
        (column list, index subsets)."""
        columns: List[t.Expression] = []

        def col_index(e: t.Expression) -> int:
            for i, c in enumerate(columns):
                if c == e:
                    return i
            columns.append(e)
            return len(columns) - 1

        if self.accept_kw("rollup"):
            self.expect_op("(")
            exprs = [self.expression()]
            while self.accept_op(","):
                exprs.append(self.expression())
            self.expect_op(")")
            idxs = [col_index(e) for e in exprs]
            sets = [tuple(idxs[:k]) for k in range(len(idxs), -1, -1)]
            return columns, tuple(sets)
        if self.accept_kw("cube"):
            self.expect_op("(")
            exprs = [self.expression()]
            while self.accept_op(","):
                exprs.append(self.expression())
            self.expect_op(")")
            idxs = [col_index(e) for e in exprs]
            sets = []
            for mask in range(1 << len(idxs), -1, -1):
                if mask < (1 << len(idxs)):
                    sets.append(tuple(i for b, i in enumerate(idxs)
                                      if mask & (1 << b)))
            return columns, tuple(sets)
        self.expect_kw("grouping")
        self.expect_kw("sets")
        self.expect_op("(")
        sets = []
        while True:
            if self.accept_op("("):
                subset = []
                if not self.at_op(")"):
                    subset.append(col_index(self.expression()))
                    while self.accept_op(","):
                        subset.append(col_index(self.expression()))
                self.expect_op(")")
                sets.append(tuple(subset))
            else:
                sets.append((col_index(self.expression()),))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return columns, tuple(sets)

    def select_item(self) -> t.SelectItem:
        if self.at_op("*"):
            self.next()
            return t.SelectItem(t.Star())
        # t.* form
        if (self.peek().kind in ("IDENT", "QIDENT")
                and self.peek(1).kind == "OP" and self.peek(1).text == "."
                and self.peek(2).kind == "OP" and self.peek(2).text == "*"):
            name = self.identifier()
            self.next()
            self.next()
            return t.SelectItem(t.Star((name,)))
        expr = self.expression()
        alias = None
        if self.accept_kw("as"):
            alias = self.identifier()
        elif self.peek().kind in ("IDENT", "QIDENT"):
            alias = self.identifier()
        return t.SelectItem(expr, alias)

    def sort_item(self) -> t.SortItem:
        expr = self.expression()
        ascending = True
        if self.accept_kw("asc"):
            ascending = True
        elif self.accept_kw("desc"):
            ascending = False
        nulls_first = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return t.SortItem(expr, ascending, nulls_first)

    # --- relations ---------------------------------------------------------
    def relation(self) -> t.Relation:
        rel = self.relation_primary()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.relation_primary()
                rel = t.Join("cross", rel, right)
                continue
            kind = None
            if self.at_kw("join"):
                kind = "inner"
            elif self.at_kw("inner"):
                self.next()
                kind = "inner"
            elif self.at_kw("left", "right", "full"):
                kind = self.next().text
                self.accept_kw("outer")
            if kind is None:
                return rel
            self.expect_kw("join")
            right = self.relation_primary()
            self.expect_kw("on")
            on = self.expression()
            rel = t.Join(kind, rel, right, on)

    def inline_values(self) -> t.InlineValues:
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.expression()]
            while self.accept_op(","):
                row.append(self.expression())
            self.expect_op(")")
            rows.append(tuple(row))
            if not self.accept_op(","):
                break
        return t.InlineValues(tuple(rows))

    def relation_primary(self) -> t.Relation:
        if self.at_kw("unnest"):
            self.next()
            self.expect_op("(")
            args = [self.expression()]
            while self.accept_op(","):
                args.append(self.expression())
            self.expect_op(")")
            ordinality = False
            if self.accept_kw("with"):
                self.expect_kw("ordinality")
                ordinality = True
            alias, col_aliases = self._relation_alias()
            return t.Unnest(tuple(args), ordinality, alias, col_aliases)
        if self.at_kw("values"):
            iv = self.inline_values()
            alias, col_aliases = self._relation_alias()
            return t.InlineValues(iv.rows, alias, col_aliases)
        if self.accept_op("("):
            if self.at_kw("values"):
                iv = self.inline_values()
                self.expect_op(")")
                alias, col_aliases = self._relation_alias()
                return t.InlineValues(iv.rows, alias, col_aliases)
            if self.at_kw("select", "with"):
                q = self.query()
                self.expect_op(")")
                alias, col_aliases = self._relation_alias()
                return t.SubqueryRelation(q, alias, col_aliases)
            if self.at_op("("):
                # ambiguous '((': a parenthesized QUERY whose first
                # set-operation operand is itself parenthesized
                # ("((SELECT..) INTERSECT SELECT..) t", SqlBase.g4
                # queryPrimary), or a parenthesized RELATION (join
                # grouping) — try the query reading first, backtrack on
                # failure
                save = self.pos
                try:
                    q = self.query()
                    self.expect_op(")")
                    alias, col_aliases = self._relation_alias()
                    return t.SubqueryRelation(q, alias, col_aliases)
                except SqlSyntaxError:
                    self.pos = save
            rel = self.relation()
            self.expect_op(")")
            return rel
        name = self.qualified_name()
        alias, _ = self._relation_alias()
        return t.Table(name, alias)

    def _relation_alias(self):
        alias = None
        col_aliases: Tuple[str, ...] = ()
        if self.accept_kw("as"):
            alias = self.identifier()
        elif self.peek().kind in ("IDENT", "QIDENT"):
            alias = self.identifier()
        if alias is not None and self.at_op("("):
            self.next()
            cols = [self.identifier()]
            while self.accept_op(","):
                cols.append(self.identifier())
            self.expect_op(")")
            col_aliases = tuple(cols)
        return alias, col_aliases

    # --- expressions (precedence climbing) ---------------------------------
    def expression(self) -> t.Expression:
        return self.or_expr()

    def or_expr(self) -> t.Expression:
        left = self.and_expr()
        while self.accept_kw("or"):
            left = t.LogicalBinary("or", left, self.and_expr())
        return left

    def and_expr(self) -> t.Expression:
        left = self.not_expr()
        while self.accept_kw("and"):
            left = t.LogicalBinary("and", left, self.not_expr())
        return left

    def not_expr(self) -> t.Expression:
        if self.accept_kw("not"):
            return t.Not(self.not_expr())
        return self.predicate()

    def predicate(self) -> t.Expression:
        left = self.additive()
        while True:
            if self.at_op("=", "<", "<=", ">", ">=", "<>", "!="):
                op = self.next().text
                if op == "!=":
                    op = "<>"
                right = self.additive()
                left = t.Comparison(op, left, right)
                continue
            negated = False
            save = self.pos
            if self.accept_kw("not"):
                negated = True
            if self.accept_kw("between"):
                low = self.additive()
                self.expect_kw("and")
                high = self.additive()
                left = t.Between(left, low, high, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.query()
                    self.expect_op(")")
                    left = t.InSubquery(left, q, negated)
                else:
                    items = [self.expression()]
                    while self.accept_op(","):
                        items.append(self.expression())
                    self.expect_op(")")
                    left = t.InList(left, tuple(items), negated)
                continue
            if self.accept_kw("like"):
                pattern = self.additive()
                escape = None
                if self.accept_kw("escape"):
                    escape = self.additive()
                left = t.Like(left, pattern, escape, negated)
                continue
            if negated:
                self.pos = save  # bare NOT belongs to not_expr
                return left
            if self.accept_kw("is"):
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                left = t.IsNull(left, neg)
                continue
            return left

    def additive(self) -> t.Expression:
        left = self.multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().text
                left = t.ArithmeticBinary(op, left, self.multiplicative())
            elif self.at_op("||"):
                self.next()
                left = t.FunctionCall("concat",
                                      (left, self.multiplicative()))
            else:
                return left

    def multiplicative(self) -> t.Expression:
        left = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            left = t.ArithmeticBinary(op, left, self.unary())
        return left

    def unary(self) -> t.Expression:
        if self.at_op("-"):
            self.next()
            return t.ArithmeticUnary("-", self.unary())
        if self.at_op("+"):
            self.next()
            return self.unary()
        return self.primary()

    def table_properties(self) -> Tuple[Tuple[str, object], ...]:
        """WITH (k = literal, ...) — literals: string, number, boolean,
        ARRAY['a', ...] (the table-properties grammar subset the
        connectors consume)."""
        self.expect_kw("with")
        self.expect_op("(")
        props = []
        while True:
            key = self.identifier()
            self.expect_op("=")
            props.append((key, self._property_value()))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return tuple(props)

    def _property_value(self):
        tok = self.peek()
        if tok.kind == "STRING":
            return self.next().text
        if tok.kind == "NUMBER":
            text = self.next().text
            return float(text) if "." in text or "e" in text else int(text)
        if self.accept_kw("true"):
            return True
        if self.accept_kw("false"):
            return False
        if self.accept_kw("array"):
            self.expect_op("[")
            items = []
            if not self.at_op("]"):
                items.append(self._property_value())
                while self.accept_op(","):
                    items.append(self._property_value())
            self.expect_op("]")
            return items
        raise SqlSyntaxError("expected property value", tok.line, tok.col)

    def privilege(self) -> str:
        tok = self.next()
        word = tok.text
        if word not in ("select", "insert", "delete", "all"):
            raise SqlSyntaxError(f"unknown privilege {word!r}",
                                 tok.line, tok.col)
        if word == "all":
            self.accept_word("privileges")
        return word

    def _opt_like(self) -> Optional[str]:
        if self.accept_kw("like"):
            tok = self.next()
            if tok.kind != "STRING":
                raise SqlSyntaxError("expected string after LIKE",
                                     tok.line, tok.col)
            return tok.text
        return None

    def _text_between(self, start_pos: int, end_pos: int) -> str:
        """Original SQL text between two token positions (used to store a
        view's defining query verbatim)."""
        if not self.sql:
            return ""
        line_off = [0]
        for ln in self.sql.splitlines(keepends=True):
            line_off.append(line_off[-1] + len(ln))

        def offset(tok: Token) -> int:
            if tok.kind == "EOF":
                return len(self.sql)
            return line_off[tok.line - 1] + tok.col - 1

        lo = offset(self.toks[start_pos])
        hi = (offset(self.toks[end_pos])
              if end_pos < len(self.toks) else len(self.sql))
        return self.sql[lo:hi].strip().rstrip(";").strip()

    def primary(self) -> t.Expression:
        e = self._primary_base()
        while True:
            if self.at_op("["):
                self.next()
                idx = self.expression()
                self.expect_op("]")
                e = t.Subscript(e, idx)
                continue
            # field deref on a computed base (identifiers consume dots in
            # qualified_name; row fields there resolve during analysis)
            if (self.at_op(".") and not isinstance(e, t.Identifier)
                    and self.peek(1).kind in ("IDENT", "QIDENT")):
                self.next()
                e = t.Deref(e, self.identifier())
                continue
            return e

    def _primary_base(self) -> t.Expression:
        tok = self.peek()
        if tok.kind == "OP" and tok.text == "?":
            self.next()
            p = t.Parameter(self._param_seq)
            self._param_seq += 1
            return p
        if tok.kind == "NUMBER":
            self.next()
            return t.NumberLiteral(tok.text)
        if tok.kind == "STRING":
            self.next()
            return t.StringLiteral(tok.text)
        if tok.kind == "OP" and tok.text == "(":
            self.next()
            if self.at_kw("select", "with"):
                q = self.query()
                self.expect_op(")")
                return t.ScalarSubquery(q)
            e = self.expression()
            self.expect_op(")")
            return e
        if tok.kind == "KEYWORD":
            return self._keyword_primary(tok)
        if tok.kind in ("IDENT", "QIDENT"):
            # function call?
            if (self.peek(1).kind == "OP" and self.peek(1).text == "("):
                if tok.text == "try_cast":
                    self.next()
                    self.expect_op("(")
                    e = self.expression()
                    self.expect_kw("as")
                    type_name = self.type_name()
                    self.expect_op(")")
                    return t.TryCast(e, type_name)
                if tok.text == "position":
                    self.next()
                    self.expect_op("(")
                    needle = self.additive()   # below the IN predicate
                    self.expect_kw("in")
                    hay = self.expression()
                    self.expect_op(")")
                    return t.FunctionCall("strpos", (hay, needle))
                return self.function_call(self.identifier())
            if (tok.kind == "IDENT" and tok.text == "decimal"
                    and self.peek(1).kind == "STRING"):
                # DECIMAL '1.2' typed literal (SqlBase.g4 numericLiteral)
                self.next()
                return t.TypedLiteral("decimal", self.next().text)
            return t.Identifier(self.qualified_name())
        raise SqlSyntaxError(f"unexpected {tok.text or 'end of input'!r}",
                             tok.line, tok.col)

    def _keyword_primary(self, tok: Token) -> t.Expression:
        word = tok.text
        if word == "null":
            self.next()
            return t.NullLiteral()
        if word == "array":
            self.next()
            self.expect_op("[")
            items: List[t.Expression] = []
            if not self.at_op("]"):
                items.append(self.expression())
                while self.accept_op(","):
                    items.append(self.expression())
            self.expect_op("]")
            return t.ArrayConstructor(tuple(items))
        if word == "row" and self.peek(1).kind == "OP" \
                and self.peek(1).text == "(":
            self.next()
            return self.function_call("row")
        if word in ("true", "false"):
            self.next()
            return t.BooleanLiteral(word == "true")
        if word in ("date", "timestamp", "time", "decimal"):
            if self.peek(1).kind == "STRING":
                self.next()
                return t.TypedLiteral(word, self.next().text)
            self.next()
            return t.Identifier((word,))
        if word == "interval":
            self.next()
            sign = 1
            if self.accept_op("-"):
                sign = -1
            val = self.next()
            if val.kind != "STRING":
                raise SqlSyntaxError("expected interval string", val.line,
                                     val.col)
            unit_tok = self.next()
            unit = unit_tok.text
            if unit not in ("year", "month", "day", "hour", "minute",
                            "second"):
                raise SqlSyntaxError(f"bad interval unit {unit!r}",
                                     unit_tok.line, unit_tok.col)
            return t.IntervalLiteral(val.text, unit, sign)
        if word == "grouping" and self.peek(1).kind == "OP" \
                and self.peek(1).text == "(":
            # grouping(col, ...) function (vs GROUPING SETS keyword)
            self.next()
            return self.function_call("grouping")
        if word == "case":
            self.next()
            operand = None
            if not self.at_kw("when"):
                operand = self.expression()
            whens = []
            while self.accept_kw("when"):
                cond = self.expression()
                self.expect_kw("then")
                whens.append((cond, self.expression()))
            default = self.expression() if self.accept_kw("else") else None
            self.expect_kw("end")
            return t.Case(operand, tuple(whens), default)
        if word == "cast":
            self.next()
            self.expect_op("(")
            e = self.expression()
            self.expect_kw("as")
            type_name = self.type_name()
            self.expect_op(")")
            return t.Cast(e, type_name)
        if word == "extract":
            self.next()
            self.expect_op("(")
            field = self.next().text
            self.expect_kw("from")
            e = self.expression()
            self.expect_op(")")
            return t.Extract(field, e)
        if word == "coalesce":
            self.next()
            self.expect_op("(")
            args = [self.expression()]
            while self.accept_op(","):
                args.append(self.expression())
            self.expect_op(")")
            return t.Coalesce(tuple(args))
        if word == "nullif":
            self.next()
            self.expect_op("(")
            first = self.expression()
            self.expect_op(",")
            second = self.expression()
            self.expect_op(")")
            return t.NullIf(first, second)
        if word == "substring":
            self.next()
            self.expect_op("(")
            e = self.expression()
            if self.accept_kw("from"):
                start = self.expression()
                length = self.expression() if self.accept_kw("for") else None
            else:
                self.expect_op(",")
                start = self.expression()
                length = None
                if self.accept_op(","):
                    length = self.expression()
            self.expect_op(")")
            args = (e, start) if length is None else (e, start, length)
            return t.FunctionCall("substr", args)
        if word == "exists":
            self.next()
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            return t.Exists(q)
        if word in ("year", "month", "day", "hour", "minute", "second",
                    "first", "last"):
            if self.peek(1).kind == "OP" and self.peek(1).text == "(":
                self.next()
                return self.function_call(word)
            self.next()
            return t.Identifier((word,))
        raise SqlSyntaxError(f"unexpected keyword {word!r}", tok.line,
                             tok.col)

    def function_call(self, name: str) -> t.Expression:
        self.expect_op("(")
        if self.accept_op("*"):
            self.expect_op(")")
            call = t.FunctionCall(name, (), is_star=True)
        elif self.at_op(")"):
            self.next()
            call = t.FunctionCall(name, ())
        else:
            distinct = bool(self.accept_kw("distinct"))
            self.accept_kw("all")
            args = [self._call_arg()]
            while self.accept_op(","):
                args.append(self._call_arg())
            self.expect_op(")")
            call = t.FunctionCall(name, tuple(args), distinct)
        if self.accept_kw("over"):
            call = dataclasses.replace(call, window=self.window_spec())
        return call

    def _call_arg(self) -> t.Expression:
        """A function argument: lambda (``x -> e`` / ``(x, y) -> e``) or
        a plain expression."""
        if (self.peek().kind in ("IDENT", "QIDENT")
                and self.peek(1).kind == "OP" and self.peek(1).text == "->"):
            param = self.identifier()
            self.next()  # ->
            return t.Lambda((param,), self.expression())
        if self.at_op("("):
            # lookahead: "(" ident ("," ident)* ")" "->"
            i = 1
            params = []
            while self.peek(i).kind in ("IDENT", "QIDENT"):
                params.append(self.peek(i).text)
                if self.peek(i + 1).kind == "OP" \
                        and self.peek(i + 1).text == ",":
                    i += 2
                    continue
                break
            if (params and self.peek(i + 1).kind == "OP"
                    and self.peek(i + 1).text == ")"
                    and self.peek(i + 2).kind == "OP"
                    and self.peek(i + 2).text == "->"):
                self.next()  # (
                names = [self.identifier()]
                while self.accept_op(","):
                    names.append(self.identifier())
                self.expect_op(")")
                self.expect_op("->")
                return t.Lambda(tuple(names), self.expression())
        return self.expression()

    def window_spec(self) -> t.WindowSpec:
        self.expect_op("(")
        partition_by: List[t.Expression] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition_by.append(self.expression())
            while self.accept_op(","):
                partition_by.append(self.expression())
        order_by: List[t.SortItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.sort_item())
            while self.accept_op(","):
                order_by.append(self.sort_item())
        frame = None
        if self.at_kw("rows", "range"):
            unit = self.next().text
            if self.accept_kw("between"):
                start = self.frame_bound()
                self.expect_kw("and")
                end = self.frame_bound()
            else:
                start = self.frame_bound()
                end = t.FrameBound("current")
            frame = t.WindowFrame(unit, start, end)
        self.expect_op(")")
        return t.WindowSpec(tuple(partition_by), tuple(order_by), frame)

    def frame_bound(self) -> t.FrameBound:
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return t.FrameBound("unbounded_preceding")
            self.expect_kw("following")
            return t.FrameBound("unbounded_following")
        if self.accept_kw("current"):
            self.expect_kw("row")
            return t.FrameBound("current")
        value = self.expression()
        if self.accept_kw("preceding"):
            return t.FrameBound("preceding", value)
        self.expect_kw("following")
        return t.FrameBound("following", value)

    def type_name(self) -> str:
        tok = self.next()
        if tok.kind not in ("IDENT", "KEYWORD"):
            raise SqlSyntaxError("expected type name", tok.line, tok.col)
        name = tok.text
        if name == "double" and self.peek().text == "precision":
            self.next()
        if name in ("array", "map", "row") and self.at_op("("):
            self.next()
            parts = []
            while not self.at_op(")"):
                if name == "row":
                    fname = self.identifier()
                    parts.append(f"{fname} {self.type_name()}")
                else:
                    parts.append(self.type_name())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return f"{name}({','.join(parts)})"
        if self.at_op("("):
            self.next()
            params = [self.next().text]
            while self.accept_op(","):
                params.append(self.next().text)
            self.expect_op(")")
            name = f"{name}({','.join(params)})"
        return name
