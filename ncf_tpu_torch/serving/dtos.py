"""Request/response DTOs for the recommendation API, on stdlib dataclasses.

Port of ``ncf_tpu/serving/dtos.py``, which builds them on pydantic; the
port carries no pydantic, so this module validates on its own.  The
fields, defaults and bounds are the reference's: ``num_recommendations``
in 1..100, ``hour`` in 0..23, at most 100 ``customer_ids``.

``from_dict`` takes a decoded JSON body and coerces it as pydantic v2's
lax mode does for JSON's types, so the same bodies pass and fail:

- ``int``: an int; a bool (``True`` -> 1); a finite float with no
  fraction inside the int64 range (``5.0`` -> 5, ``5.5`` fails); a
  string of ASCII digits with an optional sign, single underscores
  between digits, an optional ``.0...`` tail and surrounding whitespace
  (``" 5 "``, ``"1_0"``, ``"5.00"``; not ``"5.5"``, ``"1e1"``, ``"0x5"``).
- ``str``: a string only (an int fails).
- ``bool``: a bool; 0 or 1 as an int or float; the strings ``0 1 f t n y
  no yes off on false true`` in any case, without whitespace.
- ``List[str]``: a list of strings; ``Dict[str, int]``: an object whose
  values coerce to int; ``Optional``: ``None`` or the inner type.

A missing key takes the field's default; a key set to ``null`` where the
type is not ``Optional`` fails; unknown keys are ignored.  Failures raise
:class:`ValidationError`.  ``to_dict`` gives what pydantic's
``model_dump`` gives: every field in declaration order, ``None`` kept,
nested DTOs as dicts.
"""

from __future__ import annotations

import dataclasses
import math
import re
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_INT_STR = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")
_TRUE = frozenset({"1", "on", "t", "true", "y", "yes"})
_FALSE = frozenset({"0", "off", "f", "false", "n", "no"})
_MISSING = object()


class ValidationError(ValueError):
    """A body that does not fit its DTO; ``errors()`` lists each field's
    failure as ``{"loc": (...), "msg": ...}``."""

    def __init__(self, model: str, errors: List[Dict[str, Any]]):
        self._errors = errors
        lines = [f"{len(errors)} validation error(s) for {model}"]
        for e in errors:
            lines.append(".".join(str(p) for p in e["loc"]) or "body")
            lines.append(f"  {e['msg']}")
        super().__init__("\n".join(lines))

    def errors(self) -> List[Dict[str, Any]]:
        return list(self._errors)


class _Invalid(Exception):
    def __init__(self, msg: str, loc: Tuple = ()):
        super().__init__(msg)
        self.msg, self.loc = msg, loc


def _as_int(x: Any) -> int:
    if isinstance(x, bool):
        return int(x)
    if isinstance(x, int):
        return x
    if isinstance(x, float):
        if not math.isfinite(x):
            raise _Invalid("Input should be a finite number")
        if x != int(x):
            raise _Invalid("Input should be a valid integer, got a number "
                           "with a fractional part")
        if not -2.0 ** 63 <= x < 2.0 ** 63:
            raise _Invalid("Unable to parse input string as an integer, "
                           "exceeded maximum size")
        return int(x)
    if isinstance(x, str):
        s = x.strip()
        if not _INT_STR.fullmatch(s):
            raise _Invalid("Input should be a valid integer, unable to parse "
                           "string as an integer")
        return int(s.split(".")[0])
    raise _Invalid("Input should be a valid integer")


def _as_str(x: Any) -> str:
    if not isinstance(x, str):
        raise _Invalid("Input should be a valid string")
    return x


def _as_bool(x: Any) -> bool:
    if isinstance(x, bool):
        return x
    if isinstance(x, (int, float)) and x in (0, 1):
        return bool(x)
    if isinstance(x, str) and x.lower() in _TRUE | _FALSE:
        return x.lower() in _TRUE
    raise _Invalid("Input should be a valid boolean")


def _as_float(x: Any) -> float:
    if isinstance(x, (int, float)):
        return float(x)
    if isinstance(x, str):
        try:
            return float(x.strip())
        except ValueError:
            pass
    raise _Invalid("Input should be a valid number")


_SCALARS = {int: _as_int, str: _as_str, bool: _as_bool, float: _as_float}


def _coerce(tp: Any, x: Any) -> Any:
    """``x`` as the annotation ``tp`` or ``_Invalid`` (with its path)."""
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin is typing.Union:                       # Optional[inner]
        if x is None:
            return None
        return _coerce(next(a for a in args if a is not type(None)), x)
    if origin in (list, List):
        if not isinstance(x, list):
            raise _Invalid("Input should be a valid list")
        out = []
        for i, v in enumerate(x):
            try:
                out.append(_coerce(args[0], v))
            except _Invalid as e:
                raise _Invalid(e.msg, (i,) + e.loc) from None
        return out
    if origin in (dict, Dict):
        if not isinstance(x, dict):
            raise _Invalid("Input should be a valid dictionary")
        out = {}
        for k, v in x.items():
            try:
                out[_coerce(args[0], k)] = _coerce(args[1], v)
            except _Invalid as e:
                raise _Invalid(e.msg, (k,) + e.loc) from None
        return out
    if isinstance(tp, type) and issubclass(tp, _DTO):
        return tp.from_dict(x)
    return _SCALARS[tp](x)


def _check_bounds(value: Any, meta: Dict[str, Any]) -> None:
    """A field's ``metadata`` bounds: ``ge``, ``le``, ``max_length``."""
    if value is None:
        return
    if "ge" in meta and value < meta["ge"]:
        raise _Invalid(f"Input should be greater than or equal to "
                       f"{meta['ge']}")
    if "le" in meta and value > meta["le"]:
        raise _Invalid(f"Input should be less than or equal to {meta['le']}")
    if "max_length" in meta and len(value) > meta["max_length"]:
        raise _Invalid(f"List should have at most {meta['max_length']} "
                       f"items after validation, not {len(value)}")


class _DTO:
    """Validation and dumping shared by the DTO dataclasses."""

    @classmethod
    def from_dict(cls, data: Any):
        if not isinstance(data, dict):
            raise ValidationError(cls.__name__, [{
                "loc": (), "msg": "Input should be a valid dictionary or "
                                  f"instance of {cls.__name__}"}])
        hints = typing.get_type_hints(cls)
        values, errors = {}, []
        for f in dataclasses.fields(cls):
            raw = data.get(f.name, _MISSING)
            if raw is _MISSING:
                if (f.default is dataclasses.MISSING
                        and f.default_factory is dataclasses.MISSING):
                    errors.append({"loc": (f.name,), "msg": "Field required"})
                continue
            try:
                value = _coerce(hints[f.name], raw)
                _check_bounds(value, f.metadata)
            except _Invalid as e:
                errors.append({"loc": (f.name,) + e.loc, "msg": e.msg})
                continue
            except ValidationError as e:             # a nested DTO
                errors.extend({"loc": (f.name,) + err["loc"],
                               "msg": err["msg"]} for err in e.errors())
                continue
            values[f.name] = value
        if errors:
            raise ValidationError(cls.__name__, errors)
        return cls(**values)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ProductMetadata(_DTO):
    name: Optional[str] = None
    department: Optional[str] = None
    category: Optional[str] = None
    avg_price: Optional[float] = None
    popularity_score: Optional[float] = None


@dataclass
class ProductRecommendation(_DTO):
    product_id: str
    score: float
    rank: int
    metadata: Optional[ProductMetadata] = None
    explanation: Optional[str] = None


@dataclass
class RecommendationRequest(_DTO):
    customer_id: str
    num_recommendations: int = field(default=10,
                                     metadata={"ge": 1, "le": 100})
    context: Optional[Dict[str, int]] = None   # hour/day/month/day_of_year
    exclude_purchased: bool = False


@dataclass
class RecommendationResponse(_DTO):
    customer_id: str
    recommendations: List[ProductRecommendation]
    model_version: str
    inference_time_ms: float


@dataclass
class IntelligenceRequest(_DTO):
    """POST /api/v1/intelligence: the web demo's dashboard query."""

    customer_id: str
    num_recommendations: int = field(default=10,
                                     metadata={"ge": 1, "le": 100})
    hour: Optional[int] = field(default=None, metadata={"ge": 0, "le": 23})


@dataclass
class BatchRecommendationRequest(_DTO):
    customer_ids: List[str] = field(metadata={"max_length": 100})
    num_recommendations: int = field(default=10,
                                     metadata={"ge": 1, "le": 100})
    context: Optional[Dict[str, int]] = None


@dataclass
class BatchRecommendationResponse(_DTO):
    results: List[RecommendationResponse]
    total_time_ms: float


@dataclass
class ErrorResponse(_DTO):
    error: str
    detail: Optional[str] = None
    status_code: int = 500
