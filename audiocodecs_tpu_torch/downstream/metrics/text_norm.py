"""First-party Whisper-style text normalization for dWER / dCER.

The reference normalizes both transcripts with the Whisper tokenizer's
normalizer before scoring (reference ``downstream/metrics/dwer.py:96``:
``self.tokenizer.normalize(x)`` — the OpenAI English normalizer that
ships with Whisper). This module implements that normalization
first-party so the on-device dWER path needs no ``transformers`` at
metric time:

* :class:`BasicTextNormalizer` — lowercase, strip bracketed asides,
  replace marks/symbols/punctuation with spaces (the non-English path).
* :class:`EnglishTextNormalizer` — the full English pipeline:
  filler-word removal, contraction/title expansion, spelled-out number
  parsing ("twenty-one dollars and fifty cents" → "$21.50"), percent and
  currency symbols, optional British→American spelling mapping.

Behavior is oracle-tested token-for-token against the normalizer bundled
in the installed ``transformers`` (``tests/test_text_norm.py``), incl. a
randomized fuzz battery over the number grammar.
"""

from __future__ import annotations

import re
import unicodedata
from fractions import Fraction
from typing import Iterator, Optional, Union

__all__ = [
    "BasicTextNormalizer",
    "EnglishTextNormalizer",
    "EnglishNumberNormalizer",
]

# Ligatures/special letters NFKD leaves intact but the normalizer folds.
_SPECIAL_LETTERS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}

_BRACKETS = re.compile(r"[<\[][^>\]]*[>\]]")
_PARENS = re.compile(r"\(([^)]+?)\)")
_NUMERIC = re.compile(r"^\d+(\.\d+)?$")


def _strip_marks(s: str, keep: str = "", fold_diacritics: bool = False) -> str:
    """Marks/symbols/punctuation → space; optionally fold diacritics."""
    form = "NFKD" if fold_diacritics else "NFKC"
    out = []
    for ch in unicodedata.normalize(form, s):
        if ch in keep:
            out.append(ch)
        elif fold_diacritics and ch in _SPECIAL_LETTERS:
            out.append(_SPECIAL_LETTERS[ch])
        elif fold_diacritics and unicodedata.category(ch) == "Mn":
            continue
        elif unicodedata.category(ch)[0] in "MSP":
            out.append(" ")
        else:
            out.append(ch)
    return "".join(out)


class BasicTextNormalizer:
    """Language-agnostic cleanup (lowercase + symbol stripping)."""

    def __init__(self, remove_diacritics: bool = False,
                 split_letters: bool = False):
        self.remove_diacritics = remove_diacritics
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = _BRACKETS.sub("", s.lower())
        s = _PARENS.sub("", s)
        s = _strip_marks(s, fold_diacritics=self.remove_diacritics).lower()
        if self.split_letters:
            import regex as _regex

            s = " ".join(_regex.findall(r"\X", s, _regex.U))
        return re.sub(r"\s+", " ", s)


def _ones_table() -> dict[str, int]:
    names = ["one", "two", "three", "four", "five", "six", "seven",
             "eight", "nine", "ten", "eleven", "twelve", "thirteen",
             "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
             "nineteen"]
    return {n: i + 1 for i, n in enumerate(names)}


class EnglishNumberNormalizer:
    """Spelled-out → arabic numbers, one greedy left-to-right pass.

    The grammar is the Whisper normalizer's: digit-string accumulation
    (so "nineteen seventy" → "1970", "one oh one" → "101"), multiplier
    arithmetic on the sub-thousand residual, ordinal/plural suffix
    passthrough ("twentieth" → "20th"), sign/currency prefixes, percent
    suffixes, and the "point"/"double"/"triple"/"and" specials. A bare
    "one"/"ones" is kept literal (pronoun ambiguity).
    """

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = _ones_table()
        self.ones_suffixed: dict[str, tuple[int, str]] = {}
        for name, v in self.ones.items():
            plural = "sixes" if name == "six" else name + "s"
            self.ones_suffixed[plural] = (v, "s")
            if v > 3 and v != 5 and v != 12:
                ordinal = name + ("h" if name.endswith("t") else "th")
                self.ones_suffixed[ordinal] = (v, "th")
        self.ones_suffixed.update({
            "zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
            "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th"),
        })
        self.tens = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
                     "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90}
        self.tens_suffixed = {}
        for name, v in self.tens.items():
            self.tens_suffixed[name[:-1] + "ies"] = (v, "s")
            self.tens_suffixed[name[:-1] + "ieth"] = (v, "th")
        self.multipliers = {
            name: 10 ** (3 * i + 3)
            for i, name in enumerate(
                ["thousand", "million", "billion", "trillion", "quadrillion",
                 "quintillion", "sextillion", "septillion", "octillion",
                 "nonillion", "decillion"])
        }
        self.multipliers["hundred"] = 100
        self.multipliers_suffixed = {}
        for name, v in self.multipliers.items():
            self.multipliers_suffixed[name + "s"] = (v, "s")
            self.multipliers_suffixed[name + "th"] = (v, "th")
        self.decimals = self.zeros | set(self.ones)
        self.decimals |= set(self.tens)
        self.sign_prefixers = {"minus": "-", "negative": "-",
                               "plus": "+", "positive": "+"}
        self.currency_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefix_symbols = set(self.sign_prefixers.values()) | set(
            self.currency_prefixers.values())
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}
        self.words = (self.zeros | set(self.ones) | set(self.ones_suffixed)
                      | set(self.tens) | set(self.tens_suffixed)
                      | set(self.multipliers)
                      | set(self.multipliers_suffixed)
                      | set(self.sign_prefixers)
                      | set(self.currency_prefixers)
                      | set(self.suffixers) | self.specials)

    # -------------------------------------------------------- core pass

    def _emit(self, words: list[str]) -> Iterator[str]:
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None
        skip = False

        def flush(result: Union[str, int]) -> str:
            nonlocal prefix, value
            out = str(result)
            if prefix is not None:
                out = prefix + out
            prefix = None
            value = None
            return out

        def append_ones(val, n: int, prev: Optional[str]):
            """Digit-string accumulation for a 1-19 word after ``val``."""
            if isinstance(val, str) or prev in self.ones:
                if prev in self.tens and n < 10:
                    return val[:-1] + str(n)  # "twenty one" → 21
                return str(val) + str(n)  # "nineteen seventy" style concat
            if n < 10:
                return val + n if val % 10 == 0 else str(val) + str(n)
            return val + n if val % 100 == 0 else str(val) + str(n)

        def append_tens(val, n: int):
            if isinstance(val, str):
                return str(val) + str(n)
            return val + n if val % 100 == 0 else str(val) + str(n)

        for i, cur in enumerate(words):
            if skip:
                skip = False
                continue
            prev = words[i - 1] if i > 0 else None
            nxt = words[i + 1] if i + 1 < len(words) else None
            nxt_numeric = nxt is not None and _NUMERIC.match(nxt)
            has_prefix = cur[0] in self.prefix_symbols
            bare = cur[1:] if has_prefix else cur

            if _NUMERIC.match(bare):
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        value = value + str(cur)  # decimal continuation
                        continue
                    yield flush(value)
                if has_prefix:
                    prefix = cur[0]
                frac = Fraction(bare)
                value = frac.numerator if frac.denominator == 1 else bare
            elif cur not in self.words:
                if value is not None:
                    yield flush(value)
                yield flush(cur)
            elif cur in self.zeros:
                value = str(value or "") + "0"
            elif cur in self.ones:
                n = self.ones[cur]
                value = n if value is None else append_ones(value, n, prev)
            elif cur in self.ones_suffixed:
                n, suffix = self.ones_suffixed[cur]
                if value is None:
                    yield flush(str(n) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and n < 10:
                        yield flush(value[:-1] + str(n) + suffix)
                    else:
                        yield flush(str(value) + str(n) + suffix)
                elif n < 10:
                    yield flush((str(value + n) if value % 10 == 0
                                 else str(value) + str(n)) + suffix)
                else:
                    yield flush((str(value + n) if value % 100 == 0
                                 else str(value) + str(n)) + suffix)
                value = None
            elif cur in self.tens:
                n = self.tens[cur]
                value = n if value is None else append_tens(value, n)
            elif cur in self.tens_suffixed:
                n, suffix = self.tens_suffixed[cur]
                if value is None:
                    yield flush(str(n) + suffix)
                elif isinstance(value, str):
                    yield flush(str(value) + str(n) + suffix)
                else:
                    yield flush((str(value + n) if value % 100 == 0
                                 else str(value) + str(n)) + suffix)
            elif cur in self.multipliers:
                m = self.multipliers[cur]
                if value is None:
                    value = m
                elif isinstance(value, str) or value == 0:
                    try:
                        frac = Fraction(value)
                    except ValueError:
                        frac = None
                    prod = frac * m if frac is not None else None
                    if prod is not None and prod.denominator == 1:
                        value = prod.numerator
                    else:
                        yield flush(value)
                        value = m
                else:
                    value = value // 1000 * 1000 + value % 1000 * m
            elif cur in self.multipliers_suffixed:
                m, suffix = self.multipliers_suffixed[cur]
                if value is None:
                    yield flush(str(m) + suffix)
                elif isinstance(value, str):
                    try:
                        frac = Fraction(value)
                    except ValueError:
                        frac = None
                    prod = frac * m if frac is not None else None
                    if prod is not None and prod.denominator == 1:
                        yield flush(str(prod.numerator) + suffix)
                    else:
                        yield flush(value)
                        yield flush(str(m) + suffix)
                else:
                    value = value // 1000 * 1000 + value % 1000 * m
                    yield flush(str(value) + suffix)
                value = None
            elif cur in self.sign_prefixers:
                if value is not None:
                    yield flush(value)
                if nxt in self.words or nxt_numeric:
                    prefix = self.sign_prefixers[cur]
                else:
                    yield flush(cur)
            elif cur in self.currency_prefixers:
                if value is not None:
                    prefix = self.currency_prefixers[cur]
                    yield flush(value)
                else:
                    yield flush(cur)
            elif cur in self.suffixers:
                if value is None:
                    yield flush(cur)
                else:
                    suffix = self.suffixers[cur]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            yield flush(str(value) + suffix[nxt])
                            skip = True
                        else:
                            yield flush(value)
                            yield flush(cur)
                    else:
                        yield flush(str(value) + suffix)
            else:  # specials
                if nxt not in self.words and not nxt_numeric:
                    if value is not None:
                        yield flush(value)
                    yield flush(cur)
                elif cur == "and":
                    if prev not in self.multipliers:
                        # "and" only bridges "hundred and five" etc.
                        if value is not None:
                            yield flush(value)
                        yield flush(cur)
                elif cur in ("double", "triple"):
                    if nxt in self.ones or nxt in self.zeros:
                        reps = 2 if cur == "double" else 3
                        value = (str(value or "")
                                 + str(self.ones.get(nxt, 0)) * reps)
                        skip = True
                    else:
                        if value is not None:
                            yield flush(value)
                        yield flush(cur)
                elif cur == "point":
                    if nxt in self.decimals or nxt_numeric:
                        value = str(value or "") + "."

        if value is not None:
            yield flush(value)

    # ------------------------------------------------------ pre/postfix

    def _pre(self, s: str) -> str:
        # "<number> and a half" → "<number> point five"
        pieces = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, seg in enumerate(segments):
            if not seg.strip():
                continue
            pieces.append(seg)
            if i != len(segments) - 1:
                last = seg.rsplit(maxsplit=2)[-1]
                pieces.append("point five"
                              if last in self.decimals
                              or last in self.multipliers
                              else "and a half")
        s = " ".join(pieces)
        # split letter/digit boundaries, but re-attach numeric suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def _post(self, s: str) -> str:
        def cents(m):
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.group(0)

        def cent_only(m):
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.group(0)

        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", cent_only, s)
        # bare "1"/"1s" reads worse than the word (pronoun-like usage)
        return re.sub(r"\b1(s?)\b", r"one\1", s)

    def __call__(self, s: str) -> str:
        s = self._pre(s)
        s = " ".join(w for w in self._emit(s.split()) if w is not None)
        return self._post(s)


# Contraction / title / tense expansions, applied in order.
_REPLACERS = [
    (re.compile(p), r) for p, r in [
        (r"\bwon't\b", "will not"), (r"\bcan't\b", "can not"),
        (r"\blet's\b", "let us"), (r"\bain't\b", "aint"),
        (r"\by'all\b", "you all"), (r"\bwanna\b", "want to"),
        (r"\bgotta\b", "got to"), (r"\bgonna\b", "going to"),
        (r"\bi'ma\b", "i am going to"), (r"\bimma\b", "i am going to"),
        (r"\bwoulda\b", "would have"), (r"\bcoulda\b", "could have"),
        (r"\bshoulda\b", "should have"), (r"\bma'am\b", "madam"),
        (r"\bmr\b", "mister "), (r"\bmrs\b", "missus "),
        (r"\bst\b", "saint "), (r"\bdr\b", "doctor "),
        (r"\bprof\b", "professor "), (r"\bcapt\b", "captain "),
        (r"\bgov\b", "governor "), (r"\bald\b", "alderman "),
        (r"\bgen\b", "general "), (r"\bsen\b", "senator "),
        (r"\brep\b", "representative "), (r"\bpres\b", "president "),
        (r"\brev\b", "reverend "), (r"\bhon\b", "honorable "),
        (r"\basst\b", "assistant "), (r"\bassoc\b", "associate "),
        (r"\blt\b", "lieutenant "), (r"\bcol\b", "colonel "),
        (r"\bjr\b", "junior "), (r"\bsr\b", "senior "),
        (r"\besq\b", "esquire "),
        (r"'d been\b", " had been"), (r"'s been\b", " has been"),
        (r"'d gone\b", " had gone"), (r"'s gone\b", " has gone"),
        (r"'d done\b", " had done"), (r"'s got\b", " has got"),
        (r"n't\b", " not"), (r"'re\b", " are"), (r"'s\b", " is"),
        (r"'d\b", " would"), (r"'ll\b", " will"), (r"'t\b", " not"),
        (r"'ve\b", " have"), (r"'m\b", " am"),
    ]
]
_FILLERS = re.compile(r"\b(hmm|mm|mhm|mmm|uh|um)\b")


class EnglishTextNormalizer:
    """The full Whisper English normalization pipeline.

    ``spelling_mapping``: optional British→American word map (the
    reference downloads ``english.json`` with its tokenizer; pass the
    same dict here for byte-identical normalization — without it the
    rest of the pipeline is unaffected).
    """

    def __init__(self, spelling_mapping: Optional[dict] = None):
        self.numbers = EnglishNumberNormalizer()
        self.spelling = spelling_mapping or {}

    def __call__(self, s: str) -> str:
        s = _BRACKETS.sub("", s.lower())
        s = _PARENS.sub("", s)
        s = _FILLERS.sub("", s)
        s = re.sub(r"\s+'", "'", s)
        for pat, repl in _REPLACERS:
            s = pat.sub(repl, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # 1,000 → 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # keep only numeric periods
        s = _strip_marks(s, keep=".%$¢€£", fold_diacritics=True)
        s = self.numbers(s)
        if self.spelling:
            s = " ".join(self.spelling.get(w, w) for w in s.split())
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)  # orphaned symbols
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        return re.sub(r"\s+", " ", s)
