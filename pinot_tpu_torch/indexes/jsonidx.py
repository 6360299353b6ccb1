"""JSON index: flattened path/value posting tables over the dictionary.

Copy of pinot_tpu/indexes/jsonidx.py (host-only: flattening and JSON_MATCH
evaluation run per DICTIONARY VALUE on the host into a bool code table; the
device does the usual table[codes] lookup).  Same persistence region as the
JAX package, so either package loads the other's index.

Reference parity: Pinot's JSON index (pinot-segment-local/.../index/json/ —
flattened path=value posting lists consumed by JsonMatchFilterOperator,
pinot-core/.../operator/filter/JsonMatchFilterOperator.java) and the
JSON_MATCH predicate grammar (key = value, nested paths, array [*] access,
AND/OR/NOT, IS [NOT] NULL).

Re-design: JSON columns are dictionary-encoded strings, so flattening runs
per DICTIONARY VALUE (cardinality work, not row work) into per-code path
maps; JSON_MATCH evaluates host-side over those maps into a bool CODE table,
and the device work is the same table[codes] lookup as any dictionary
predicate.  Arrays flatten under the path with "[*]"; Pinot's flattened-doc
semantics (one match within a single array element) collapse to ANY-element
semantics, documented delta."""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def flatten_json(doc: Any, prefix: str = "$") -> Dict[str, List[Any]]:
    """One JSON document -> {path: [scalar values]} (arrays under [*])."""
    out: Dict[str, List[Any]] = {}

    def walk(node: Any, path: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif isinstance(node, list):
            for v in node:
                walk(v, f"{path}[*]")
        else:
            out.setdefault(path, []).append(node)

    walk(doc, prefix)
    return out


class JsonIndex:
    KIND = "json"

    def __init__(self, flattened: List[Dict[str, List[Any]]]):
        # flattened[code] = {path: [values]} for dictionary entry `code`
        self.flattened = flattened

    @staticmethod
    def build(dict_values: np.ndarray) -> "JsonIndex":
        flat: List[Dict[str, List[Any]]] = []
        for v in dict_values:
            try:
                flat.append(flatten_json(json.loads(v)))
            except (json.JSONDecodeError, TypeError):
                flat.append({})
        return JsonIndex(flat)

    # -- JSON_MATCH evaluation -> bool table over codes -------------------
    def match(self, condition: str) -> np.ndarray:
        pred = _JsonMatchParser(condition).parse()
        return np.array([pred(f) for f in self.flattened], dtype=bool)

    # -- persistence ------------------------------------------------------
    def to_regions(self, prefix: str):
        payload = json.dumps(self.flattened).encode("utf-8")
        return [(f"{prefix}.paths", np.frombuffer(payload, dtype=np.uint8))]

    def meta(self) -> Dict[str, Any]:
        return {"kind": self.KIND}

    @staticmethod
    def from_regions(meta: Dict[str, Any], regions, prefix: str) -> "JsonIndex":
        payload = bytes(np.asarray(regions[f"{prefix}.paths"]))
        return JsonIndex(json.loads(payload.decode("utf-8")))


def _normalize_path(p: str) -> str:
    p = p.strip()
    if not p.startswith("$"):
        p = "$." + p
    # numeric array access "[0]" matches our "[*]" flattening (documented:
    # positional access degrades to ANY-element)
    return re.sub(r"\[\d+\]", "[*]", p)


class _JsonMatchParser:
    """Tiny recursive-descent parser for the JSON_MATCH condition grammar:
    '"$.a.b" = ''x''' | path != v | path > v | path IS [NOT] NULL |
    cond AND cond | cond OR cond | NOT cond | (cond)."""

    _TOKEN = re.compile(
        r"""\s*(?:
            (?P<lpar>\()|(?P<rpar>\))|
            (?P<op><=|>=|!=|<>|=|<|>)|
            (?P<kw>(?i:AND|OR|NOT|IS|NULL|IN))\b|
            (?P<str>'(?:[^']|'')*')|
            (?P<dstr>"(?:[^"]|"")*")|
            (?P<num>-?\d+(?:\.\d+)?)|
            (?P<word>[\w$.\[\]*]+)
        )""",
        re.VERBOSE,
    )

    def __init__(self, s: str):
        self.tokens: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(s):
            m = self._TOKEN.match(s, pos)
            if not m:
                if s[pos:].strip() == "":
                    break
                raise ValueError(f"JSON_MATCH: cannot tokenize {s[pos:]!r}")
            pos = m.end()
            for k, v in m.groupdict().items():
                if v is not None:
                    self.tokens.append((k, v))
                    break
        self.i = 0

    def _peek(self) -> Optional[Tuple[str, str]]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def _next(self) -> Tuple[str, str]:
        t = self._peek()
        if t is None:
            raise ValueError("JSON_MATCH: unexpected end of condition")
        self.i += 1
        return t

    def _accept_kw(self, kw: str) -> bool:
        t = self._peek()
        if t and t[0] == "kw" and t[1].upper() == kw:
            self.i += 1
            return True
        return False

    def parse(self):
        node = self._or()
        if self._peek() is not None:
            raise ValueError(f"JSON_MATCH: trailing tokens {self.tokens[self.i:]}")
        return node

    def _or(self):
        left = self._and()
        while self._accept_kw("OR"):
            right = self._and()
            left = (lambda a, b: (lambda f: a(f) or b(f)))(left, right)
        return left

    def _and(self):
        left = self._unary()
        while self._accept_kw("AND"):
            right = self._unary()
            left = (lambda a, b: (lambda f: a(f) and b(f)))(left, right)
        return left

    def _unary(self):
        if self._accept_kw("NOT"):
            inner = self._unary()
            return lambda f: not inner(f)
        t = self._peek()
        if t and t[0] == "lpar":
            self.i += 1
            inner = self._or()
            k, _ = self._next()
            if k != "rpar":
                raise ValueError("JSON_MATCH: expected ')'")
            return inner
        return self._comparison()

    def _comparison(self):
        k, v = self._next()
        if k == "str":
            path = v[1:-1].replace("''", "'")
        elif k == "dstr":
            path = v[1:-1].replace('""', '"')
        elif k == "word":
            path = v
        else:
            raise ValueError(f"JSON_MATCH: expected a path, got {v!r}")
        path = _normalize_path(path)
        if self._accept_kw("IS"):
            neg = self._accept_kw("NOT")
            if not self._accept_kw("NULL"):
                raise ValueError("JSON_MATCH: expected NULL after IS [NOT]")
            if neg:
                return lambda f: path in f  # IS NOT NULL = path exists
            return lambda f: path not in f
        k2, op = self._next()
        if k2 != "op":
            raise ValueError(f"JSON_MATCH: expected an operator after {path!r}, got {op!r}")
        vk, vv = self._next()
        if vk == "str":
            val: Any = vv[1:-1].replace("''", "'")
        elif vk == "num":
            val = float(vv) if "." in vv else int(vv)
        elif vk == "word":
            val = {"true": True, "false": False}.get(vv.lower(), vv)
        else:
            raise ValueError(f"JSON_MATCH: bad literal {vv!r}")

        def cmp(f: Dict[str, List[Any]]) -> bool:
            vals = f.get(path)
            if vals is None:
                return False
            for x in vals:
                try:
                    if op == "=" and _eq(x, val):
                        return True
                    if op in ("!=", "<>") and not _eq(x, val):
                        return True
                    if op == "<" and x < val:
                        return True
                    if op == "<=" and x <= val:
                        return True
                    if op == ">" and x > val:
                        return True
                    if op == ">=" and x >= val:
                        return True
                except TypeError:
                    continue
            return False

        return cmp


def _eq(a: Any, b: Any) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b or a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b
