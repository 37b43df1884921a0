"""The port's copy of ``ncf_tpu/naming`` (stdlib only): product-name
generation, parsing and validation, the same names from the same seed."""

from ncf_tpu_torch.naming.generator import ProductNameGenerator, TextClient
from ncf_tpu_torch.naming.parser import ParsedProduct, parse_response
from ncf_tpu_torch.naming.prompts import CATEGORY_PROMPTS, prompt_for_category
from ncf_tpu_torch.naming.validators import (
    validate_category_keywords,
    validate_line_format,
)

__all__ = [
    "ProductNameGenerator",
    "TextClient",
    "ParsedProduct",
    "parse_response",
    "CATEGORY_PROMPTS",
    "prompt_for_category",
    "validate_line_format",
    "validate_category_keywords",
]
