"""The one generator of query traffic: it reads a mix's data file
(`perfbench/traffic/<mix>.json`) and yields passes of executions.

A mix file holds:

- `order`: the queries of a pass, by their numbers in the configuration's
  query module (`dataset.queries`, which turns parameters into text);
- `shuffle`: whether each pass takes its own random order of them;
- `parameters`: per query, each substitution parameter's value, or the rule
  it is drawn by for every execution, in the order they are drawn:
  `{"int": [lo, hi]}`, `{"choice": [...]}` (with `"not": NAME`, a value
  other than that parameter's), `{"join": [[...], ...], "sep": s}` (one of
  each list, joined), `{"day"|"month": [first, last]}` (a date, the first
  of a month), `{"year": [first, last]}` (January 1), `{"cents": [lo, hi]}`
  (hundredths), and `"distinct": k` on `int` or `choice` (k distinct draws,
  a list; `"text": true` gives them as text).

Every draw comes from the run's seed, so one seed gives one stream.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class Execution:
    qn: int
    raw: dict
    fields: dict
    statements: list

    @property
    def key(self) -> str:
        """The execution's text, which names its parameters."""
        return "\n".join(self.statements)


def load_mix(root: str, name: str) -> dict:
    with open(os.path.join(root, "perfbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _days(first: str, last: str, unit: str) -> np.ndarray:
    return np.arange(np.datetime64(first, unit), np.datetime64(last, unit) + 1)


def _draw(rng, rule, drawn: dict):
    if not isinstance(rule, dict):
        return rule
    k = rule.get("distinct")
    if "int" in rule:
        lo, hi = rule["int"]
        pool = list(range(lo, hi + 1))
    elif "choice" in rule:
        pool = [v for v in rule["choice"] if v != drawn.get(rule.get("not"))]
    elif "join" in rule:
        return rule.get("sep", "").join(str(part[rng.integers(len(part))])
                                        for part in rule["join"])
    elif "day" in rule:
        days = _days(*rule["day"], "D")
        return str(days[rng.integers(len(days))])
    elif "month" in rule:
        months = _days(*rule["month"], "M")
        return f"{months[rng.integers(len(months))]}-01"
    elif "year" in rule:
        lo, hi = rule["year"]
        return f"{int(rng.integers(lo, hi + 1))}-01-01"
    elif "cents" in rule:
        lo, hi = rule["cents"]
        return int(rng.integers(lo, hi + 1)) / 100
    else:
        raise ValueError(f"no rule in {rule!r}")
    if k is None:
        return pool[rng.integers(len(pool))]
    picks = [pool[i] for i in rng.permutation(len(pool))[:k]]
    return [str(v) for v in picks] if rule.get("text") else picks


class Stream:
    """Passes of executions of one mix, drawn from one seed; `queries` is
    the configuration's query module (`derive`, `statements`)."""

    def __init__(self, mix: dict, seed: int, sf: float, queries) -> None:
        self.mix = mix
        self.sf = sf
        self.queries = queries
        self.rng = np.random.default_rng([seed, 0x5EED])

    def execution(self, qn: int) -> Execution:
        raw: dict = {}
        for name, rule in self.mix["parameters"][str(qn)].items():
            raw[name] = _draw(self.rng, rule, raw)
        fields = self.queries.derive(qn, raw, self.sf)
        return Execution(qn, raw, fields, self.queries.statements(qn, fields))

    def next_pass(self) -> list[Execution]:
        order = list(self.mix["order"])
        if self.mix.get("shuffle"):
            order = [order[i] for i in self.rng.permutation(len(order))]
        return [self.execution(qn) for qn in order]
