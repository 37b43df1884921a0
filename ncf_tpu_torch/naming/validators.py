"""Format + category validation for generated product names.

Capability-parity with the reference validators (reference:
src/llm/format_validator.py:1-41 — line-format regex checks — and
src/llm/category_validator.py:1-82 — required/forbidden keyword rules per
category).
"""

from __future__ import annotations

from typing import List, Tuple

from ncf_tpu_torch.naming.parser import parse_line
from ncf_tpu_torch.naming.prompts import CATEGORY_RULES


def validate_line_format(line: str) -> Tuple[bool, str]:
    """Does the line parse as ``Name (Size) [Customizations]``?
    Returns (ok, reason)."""
    p = parse_line(line)
    if p is None:
        return False, "line does not match 'Name (Size) [Customizations]'"
    if len(p.name) < 3:
        return False, "name too short"
    if len(p.name) > 80:
        return False, "name too long"
    return True, ""


def validate_category_keywords(line: str, category: str) -> Tuple[bool, str]:
    """Category keyword rules: at least one required keyword, no
    forbidden keywords (category_validator.py semantics)."""
    rule = CATEGORY_RULES.get(category)
    if rule is None:
        return True, ""
    lowered = line.lower()
    for bad in rule["forbidden"]:
        if bad in lowered:
            return False, f"forbidden keyword {bad!r} for category {category}"
    if rule["required"] and not any(k in lowered for k in rule["required"]):
        return False, (f"none of the required keywords for {category} "
                       f"({', '.join(rule['required'][:3])}, ...)")
    return True, ""


def validate_batch(lines: List[str], category: str) -> List[str]:
    """Filter to lines passing both validators."""
    out = []
    for line in lines:
        ok1, _ = validate_line_format(line)
        ok2, _ = validate_category_keywords(line, category)
        if ok1 and ok2:
            out.append(line)
    return out
