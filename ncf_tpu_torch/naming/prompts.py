"""Per-category product-name prompt templates and format rules.

Capability-parity with the reference's LLM prompt library (reference:
src/llm/product_prompts.py:4-226): a prompt per category code instructing
the generator to emit ``Name (Size) [Customizations]`` lines, plus
per-category keyword constraints consumed by the validators.
"""

from __future__ import annotations

from typing import Dict

LINE_FORMAT = "Name (Size) [Customization1, Customization2]"

# category code -> (description, required keywords, forbidden keywords)
CATEGORY_RULES: Dict[str, Dict] = {
    "MTO": {"desc": "made-to-order food items like subs and wraps",
            "required": ["sub", "wrap", "sandwich", "burrito", "melt"],
            "forbidden": ["soda", "cigarette"]},
    "RTE": {"desc": "ready-to-eat packaged meals and salads",
            "required": ["salad", "bowl", "meal", "box", "cup"],
            "forbidden": ["fountain"]},
    "HOT": {"desc": "hot foods like pizza slices and hot dogs",
            "required": ["hot", "pizza", "dog", "pretzel", "tender"],
            "forbidden": ["frozen"]},
    "CLD": {"desc": "cold grab-and-go foods",
            "required": ["cold", "parfait", "fruit", "veggie", "hummus"],
            "forbidden": ["hot"]},
    "FTN": {"desc": "fountain drinks in cup sizes",
            "required": ["fountain", "oz", "drink", "freeze"],
            "forbidden": ["bottle", "can"]},
    "COF": {"desc": "coffee and espresso drinks",
            "required": ["coffee", "latte", "espresso", "brew", "cappuccino"],
            "forbidden": ["beer"]},
    "BEV": {"desc": "packaged bottled and canned beverages",
            "required": ["bottle", "can", "oz", "pack"],
            "forbidden": ["fountain"]},
    "NRG": {"desc": "energy drinks",
            "required": ["energy", "oz", "can"],
            "forbidden": ["coffee"]},
    "H2O": {"desc": "bottled and sparkling water",
            "required": ["water", "spring", "sparkling", "oz"],
            "forbidden": ["soda"]},
    "CHP": {"desc": "chips and salty snacks",
            "required": ["chips", "crisps", "oz", "pretzels"],
            "forbidden": ["candy"]},
    "CND": {"desc": "candy and chocolate",
            "required": ["candy", "chocolate", "gummy", "bar", "mints"],
            "forbidden": ["chips"]},
    "NUT": {"desc": "nuts, seeds and trail mixes",
            "required": ["nuts", "seeds", "trail", "almonds", "cashews"],
            "forbidden": []},
    "JRK": {"desc": "jerky and meat snacks",
            "required": ["jerky", "sticks", "meat", "beef"],
            "forbidden": []},
}

DEFAULT_RULE = {"desc": "convenience-store products",
                "required": [], "forbidden": []}

CATEGORY_PROMPTS: Dict[str, str] = {}


def prompt_for_category(category: str, count: int = 10) -> str:
    """Build the generation prompt for one category
    (product_prompts.py prompt-assembly behavior)."""
    rule = CATEGORY_RULES.get(category, DEFAULT_RULE)
    lines = [
        f"Generate {count} distinct product names for {rule['desc']} "
        f"(category code {category}).",
        f"Format each line exactly as: {LINE_FORMAT}",
        "Size in parentheses; customizations in square brackets, "
        "comma-separated; one product per line; no numbering.",
    ]
    if rule["required"]:
        lines.append("Names should relate to: " + ", ".join(rule["required"]))
    if rule["forbidden"]:
        lines.append("Never mention: " + ", ".join(rule["forbidden"]))
    return "\n".join(lines)


for _cat in CATEGORY_RULES:
    CATEGORY_PROMPTS[_cat] = prompt_for_category(_cat)
