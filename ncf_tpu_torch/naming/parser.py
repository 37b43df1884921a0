"""Response parsing: ``Name (Size) [Customizations]`` lines -> products.

Capability-parity with the reference response parser (reference:
src/llm/response_parser.py:19-215): regex extraction of name/size/
customizations plus dietary and hot/cold keyword flags.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

LINE_RE = re.compile(
    r"^\s*(?P<name>[^()\[\]]+?)\s*"
    r"(?:\((?P<size>[^()]*)\))?\s*"
    r"(?:\[(?P<custom>[^\[\]]*)\])?\s*$")

DIETARY_KEYWORDS = {
    "vegan": "vegan", "vegetarian": "vegetarian", "gluten-free": "gluten_free",
    "gluten free": "gluten_free", "sugar-free": "sugar_free",
    "sugar free": "sugar_free", "keto": "keto", "organic": "organic",
    "low-fat": "low_fat", "diet": "diet",
}
HOT_KEYWORDS = ("hot", "grilled", "toasted", "baked", "fried", "warm")
COLD_KEYWORDS = ("cold", "iced", "frozen", "chilled", "fresh")


@dataclass
class ParsedProduct:
    name: str
    size: Optional[str] = None
    customizations: List[str] = field(default_factory=list)
    dietary_flags: List[str] = field(default_factory=list)
    is_hot: bool = False
    is_cold: bool = False


def parse_line(line: str) -> Optional[ParsedProduct]:
    """One ``Name (Size) [A, B]`` line -> ParsedProduct, or None
    (response_parser.py line regex + keyword extraction)."""
    line = line.strip().lstrip("-*").strip()
    # drop leading enumeration like "1." / "2)"
    line = re.sub(r"^\d+[.)]\s*", "", line)
    if not line:
        return None
    m = LINE_RE.match(line)
    if not m or not m.group("name").strip():
        return None
    name = m.group("name").strip()
    size = (m.group("size") or "").strip() or None
    customs = [c.strip() for c in (m.group("custom") or "").split(",")
               if c.strip()]
    lowered = line.lower()
    dietary = sorted({flag for kw, flag in DIETARY_KEYWORDS.items()
                      if kw in lowered})
    return ParsedProduct(
        name=name, size=size, customizations=customs,
        dietary_flags=dietary,
        is_hot=any(k in lowered for k in HOT_KEYWORDS),
        is_cold=any(k in lowered for k in COLD_KEYWORDS))


def parse_response(text: str) -> List[ParsedProduct]:
    """All parseable lines of a generation response."""
    out = []
    for line in text.splitlines():
        p = parse_line(line)
        if p is not None:
            out.append(p)
    return out
