"""Product-name generation: pluggable text client + template fallback.

Capability-parity with the reference's LLM text generation stack
(reference: src/llm/vertex_client.py:9-103 — a retrying Vertex LLM client
— and src/llm/text_generator.py:15-128 — category-batched generation with
placeholder fallback).  This environment has zero egress, so the default
client is the deterministic template expander (the reference's own
fallback path); any callable ``prompt -> text`` can be plugged in as the
client, with the same bounded-retry + validate + parse loop around it.
"""

from __future__ import annotations

import logging
import random
from typing import Callable, Dict, List, Optional

from ncf_tpu_torch.naming.parser import ParsedProduct, parse_response
from ncf_tpu_torch.naming.prompts import CATEGORY_RULES, prompt_for_category
from ncf_tpu_torch.naming.validators import (
    validate_category_keywords,
    validate_line_format,
)

log = logging.getLogger(__name__)

TextClient = Callable[[str], str]

# Template vocabulary for the offline generator.
_ADJECTIVES = ["Classic", "Spicy", "Smoky", "Sweet", "Zesty", "Double",
               "Loaded", "Fresh", "Golden", "Crispy", "Honey", "Ranch"]
_SIZES = ["Small", "Medium", "Large", "12 oz", "16 oz", "20 oz", "24 oz",
          "2 oz", "Family Size", "Single"]
_CUSTOMIZATIONS = ["No Onions", "Extra Cheese", "Toasted", "Light Ice",
                   "Double Shot", "Whole Grain", "Low Sodium", "Extra Sauce"]


class _TemplateClient:
    """Deterministic offline text client: expands category keyword
    templates into format-conforming lines (the placeholder-fallback
    behavior of text_generator.py)."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def __call__(self, prompt: str) -> str:
        # category code is embedded in the prompt by prompt_for_category
        category = None
        for code in CATEGORY_RULES:
            if f"category code {code}" in prompt:
                category = code
                break
        count = 10
        for tok in prompt.split():
            if tok.isdigit():
                count = int(tok)
                break
        nouns = (CATEGORY_RULES.get(category, {}).get("required")
                 or ["item"])
        lines = []
        for i in range(count):
            adj = self._rng.choice(_ADJECTIVES)
            noun = nouns[i % len(nouns)].title()
            size = self._rng.choice(_SIZES)
            customs = self._rng.sample(
                _CUSTOMIZATIONS, k=self._rng.randint(0, 2))
            suffix = f" [{', '.join(customs)}]" if customs else ""
            lines.append(f"{adj} {noun} #{i + 1} ({size}){suffix}")
        return "\n".join(lines)


class ProductNameGenerator:
    """Category-batched generation with validation, retry, and fallback
    (text_generator.py:15-128 loop shape; vertex_client.py retry policy
    of 3 bounded attempts)."""

    def __init__(self, client: Optional[TextClient] = None,
                 max_attempts: int = 3, seed: int = 0):
        self.client = client or _TemplateClient(seed)
        self.max_attempts = max_attempts

    def generate_for_category(self, category: str,
                              count: int = 10) -> List[ParsedProduct]:
        """Generate >=count valid products for a category; falls back to
        plain placeholders if the client never yields enough."""
        products: Dict[str, ParsedProduct] = {}
        for attempt in range(self.max_attempts):
            prompt = prompt_for_category(category, count)
            try:
                text = self.client(prompt)
            except Exception as e:  # noqa: BLE001 — client error boundary
                log.warning("naming client failed (attempt %d): %s",
                            attempt + 1, e)
                continue
            for line in text.splitlines():
                ok1, _ = validate_line_format(line)
                ok2, _ = validate_category_keywords(line, category)
                if not (ok1 and ok2):
                    continue
                for p in parse_response(line):
                    products.setdefault(p.name, p)
            if len(products) >= count:
                break
        # placeholder fallback (text_generator.py fallback path)
        i = 0
        while len(products) < count:
            name = f"{category} Product {i + 1}"
            products.setdefault(name, ParsedProduct(name=name))
            i += 1
        return list(products.values())[:count]

    def generate_catalog(self, category_counts: Dict[str, int]
                         ) -> Dict[str, List[ParsedProduct]]:
        return {cat: self.generate_for_category(cat, n)
                for cat, n in category_counts.items()}
