"""SQL tokenizer (Postgres-flavored).

Token kinds: KEYWORD (upper-cased match against KEYWORDS), IDENT, NUMBER,
STRING ('' escaping), OP, PUNCT, EOF. Line comments `--` and block comments
are stripped.
"""

from __future__ import annotations

from dataclasses import dataclass

from sqlrs_tpu_torch.errors import ParserError

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "AS", "AND", "OR", "NOT", "DISTINCT", "JOIN", "INNER", "LEFT",
    "RIGHT", "FULL", "CROSS", "OUTER", "ON", "TRUE", "FALSE", "NULL", "ASC",
    "DESC", "CREATE", "TABLE", "INSERT", "INTO", "VALUES", "COPY", "EXPLAIN",
    "SHOW", "TABLES", "DESCRIBE", "DESC_TABLE", "CAST", "DATE", "INTERVAL",
    "YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "UNSIGNED",
    "DELIMITER", "HEADER", "IS", "IN", "EXISTS", "BETWEEN", "LIKE", "CASE",
    "WHEN", "THEN", "ELSE", "END", "UNION", "ALL", "EXTRACT", "WITH", "VIEW",
    "DROP", "SUBSTRING", "FOR", "IF",
}

MULTI_OPS = ["<>", "!=", ">=", "<=", "=>", "||"]
SINGLE_OPS = "+-*/%<>=!"
PUNCT = "(),.;"


@dataclass
class Token:
    kind: str  # KEYWORD | IDENT | NUMBER | STRING | OP | PUNCT | EOF
    value: str
    pos: int

    def is_kw(self, kw: str) -> bool:
        return self.kind == "KEYWORD" and self.value == kw


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise ParserError("unterminated block comment")
            i = j + 2
            continue
        if c == "'":
            # string literal with '' escaping
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise ParserError("unterminated string literal")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise ParserError("unterminated quoted identifier")
            tokens.append(Token("IDENT", sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                if sql[j] == ".":
                    # "1." followed by non-digit is number then punct
                    if j + 1 >= n or not sql[j + 1].isdigit():
                        break
                    seen_dot = True
                j += 1
            tokens.append(Token("NUMBER", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            up = word.upper()
            if up in KEYWORDS:
                tokens.append(Token("KEYWORD", up, i))
            else:
                tokens.append(Token("IDENT", word, i))
            i = j
            continue
        matched = False
        for op in MULTI_OPS:
            if sql.startswith(op, i):
                tokens.append(Token("OP", op, i))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in SINGLE_OPS:
            tokens.append(Token("OP", c, i))
            i += 1
            continue
        if c in PUNCT:
            tokens.append(Token("PUNCT", c, i))
            i += 1
            continue
        raise ParserError(f"unexpected character {c!r} at position {i}")
    tokens.append(Token("EOF", "", n))
    return tokens
