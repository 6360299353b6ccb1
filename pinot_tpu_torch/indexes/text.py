"""Text index: tokenized posting tables over the dictionary.

Copy of pinot_tpu/indexes/text.py (host-only: tokenization and TEXT_MATCH
evaluation run per DICTIONARY VALUE on the host into a bool code table; the
device does the usual table[codes] lookup).  Same persistence region as the
JAX package, so either package loads the other's index.

Reference parity: Pinot's Lucene-backed text index
(pinot-segment-local/.../index/text/, consumed by TEXT_MATCH through
TextMatchFilterOperator) plus the native-FST regex dictionaries
(pinot-segment-local/.../segment/local/utils/nativefst/).  Re-design:
strings are dictionary-encoded, so tokenization runs per DICTIONARY VALUE
into token -> code-bitmap tables; TEXT_MATCH queries evaluate host-side
into one bool code table and the device does the usual table[codes]
lookup.  Query grammar: terms (implicit AND), OR, NOT, "quoted phrase"
(substring), trailing-* prefixes, /regex/ terms (RE over the token
dictionary — the FST-regex analog, O(tokens) not O(rows)), mid-token
wildcards (te*m, t?m), and term~N fuzzy matching (banded Levenshtein over
the token dictionary; ~ defaults to distance 2 like Lucene).  Documented
delta: no boosts / fields."""
from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np

_TOKEN_RX = re.compile(r"[A-Za-z0-9_]+")


def tokenize(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN_RX.findall(text)]


class TextIndex:
    KIND = "text"

    def __init__(self, tokens: Dict[str, np.ndarray], values: np.ndarray):
        self.tokens = tokens  # token -> bool[cardinality]
        self.values = values  # original dictionary values (phrase queries)

    @staticmethod
    def build(dict_values: np.ndarray) -> "TextIndex":
        card = len(dict_values)
        tokens: Dict[str, np.ndarray] = {}
        for code, v in enumerate(dict_values):
            for t in set(tokenize(str(v))):
                tbl = tokens.get(t)
                if tbl is None:
                    tbl = tokens[t] = np.zeros(card, dtype=bool)
                tbl[code] = True
        return TextIndex(tokens, np.asarray(dict_values, dtype=object))

    # -- TEXT_MATCH evaluation -> bool table over codes --------------------
    def match(self, query: str) -> np.ndarray:
        card = len(self.values)
        terms = self._parse(query)
        if not terms:
            return np.zeros(card, dtype=bool)
        # OR groups of AND terms
        result = np.zeros(card, dtype=bool)
        for group in terms:
            g = np.ones(card, dtype=bool)
            for negate, kind, term in group:
                t = self._eval_term(kind, term, card)
                g &= ~t if negate else t
            result |= g
        return result

    def _eval_term(self, kind: str, term, card: int) -> np.ndarray:
        if kind == "phrase":
            needle = term.lower()
            return np.array([needle in str(v).lower() for v in self.values], dtype=bool)
        if kind == "prefix":
            out = np.zeros(card, dtype=bool)
            for tok, tbl in self.tokens.items():
                if tok.startswith(term):
                    out |= tbl
            return out
        if kind == "regex":
            # regex over the TOKEN DICTIONARY, never the rows — the same
            # O(distinct tokens) trade as the reference's FST regex
            rx = re.compile(term)
            out = np.zeros(card, dtype=bool)
            for tok, tbl in self.tokens.items():
                if rx.fullmatch(tok):
                    out |= tbl
            return out
        if kind == "fuzzy":
            base, dist = term
            out = np.zeros(card, dtype=bool)
            for tok, tbl in self.tokens.items():
                if abs(len(tok) - len(base)) <= dist and _edit_within(base, tok, dist):
                    out |= tbl
            return out
        tbl = self.tokens.get(term)
        return tbl.copy() if tbl is not None else np.zeros(card, dtype=bool)

    @staticmethod
    def _parse(query: str):
        """-> list of OR-groups, each a list of (negate, kind, term)."""
        groups: List[List] = [[]]
        pos = 0
        rx = re.compile(r'\s*(?:(?P<or>(?i:OR))\b|(?P<not>(?i:NOT))\b|(?P<phrase>"[^"]*")|(?P<term>\S+))')
        pending_not = False
        while pos < len(query):
            m = rx.match(query, pos)
            if not m:
                break
            pos = m.end()
            if m.group("or"):
                groups.append([])
                pending_not = False
            elif m.group("not"):
                pending_not = True
            elif m.group("phrase"):
                groups[-1].append((pending_not, "phrase", m.group("phrase")[1:-1]))
                pending_not = False
            else:
                raw = m.group("term")
                if len(raw) >= 2 and raw.startswith("/") and raw.endswith("/"):
                    # /regex/ term (Lucene RegexpQuery syntax); tokens are
                    # lowercase, so the pattern compiles case-insensitively
                    groups[-1].append((pending_not, "regex", f"(?i:{raw[1:-1]})"))
                    pending_not = False
                    continue
                term = raw.lower()
                fz = re.fullmatch(r"(.+?)~(\d*)", term)
                if fz:
                    dist = int(fz.group(2)) if fz.group(2) else 2
                    groups[-1].append((pending_not, "fuzzy", (fz.group(1), dist)))
                elif term.endswith("*") and "*" not in term[:-1] and "?" not in term:
                    groups[-1].append((pending_not, "prefix", term.rstrip("*")))
                elif "*" in term or "?" in term:
                    # mid-token wildcards -> anchored regex over tokens
                    pat = "".join(
                        ".*" if ch == "*" else "." if ch == "?" else re.escape(ch)
                        for ch in term
                    )
                    groups[-1].append((pending_not, "regex", pat))
                else:
                    groups[-1].append((pending_not, "term", term))
                pending_not = False
        return [g for g in groups if g]

    # -- persistence -------------------------------------------------------
    def to_regions(self, prefix: str):
        import json

        payload = json.dumps({t: np.nonzero(tbl)[0].tolist() for t, tbl in self.tokens.items()}).encode()
        return [(f"{prefix}.tokens", np.frombuffer(payload, dtype=np.uint8))]

    def meta(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "cardinality": len(self.values)}

    @staticmethod
    def from_regions(meta: Dict[str, Any], regions, prefix: str, dict_values=None) -> "TextIndex":
        import json

        card = meta["cardinality"]
        raw = json.loads(bytes(np.asarray(regions[f"{prefix}.tokens"])).decode())
        tokens = {}
        for t, codes in raw.items():
            tbl = np.zeros(card, dtype=bool)
            tbl[np.asarray(codes, dtype=np.int64)] = True
            tokens[t] = tbl
        vals = dict_values if dict_values is not None else np.array([""] * card, dtype=object)
        return TextIndex(tokens, vals)


def _edit_within(a: str, b: str, k: int) -> bool:
    """Banded Levenshtein: True iff edit distance(a, b) <= k (the fuzzy-term
    predicate; band width 2k+1 keeps it O(len * k))."""
    la, lb = len(a), len(b)
    if abs(la - lb) > k:
        return False
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        lo = max(1, i - k)
        hi = min(lb, i + k)
        if lo > 1:
            cur[lo - 1] = k + 1
        for j in range(lo, hi + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        if hi < lb:
            cur[hi + 1 :] = [k + 1] * (lb - hi)
        prev = cur
        if min(prev[lo - 1 : hi + 1]) > k:
            return False
    return prev[lb] <= k
