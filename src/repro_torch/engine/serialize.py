"""The one JSON-safe serializer for run payloads.

Every driver and benchmark that writes results to disk goes through
``to_jsonable`` so strict-JSON consumers (``allow_nan=False``) never see
NaN/Inf (empty-aggregation async steps carry NaN losses), numpy scalars,
or dataclasses. ``dump_json`` is the matching one-line file writer.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

import numpy as np


def to_jsonable(x: Any) -> Any:
    """Recursively convert ``x`` into strict-JSON-safe builtins.

    NaN/Inf -> None; numpy scalars/arrays -> builtins/lists; dataclasses
    and mappings -> dicts; tuples/sets -> lists. Unknown objects fall back
    to ``str`` rather than failing a whole results dump.
    """
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return to_jsonable(float(x))
    if isinstance(x, np.ndarray):
        # 0-d arrays tolist() to a bare scalar, n-d to nested lists
        return to_jsonable(x.tolist())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_jsonable(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set)):
        return [to_jsonable(v) for v in x]
    if hasattr(x, "tolist"):  # torch tensors (any device), no torch import
        return to_jsonable(x.tolist())
    return str(x)


def dump_json(path: str, payload: Any, indent: int = 1) -> None:
    """Write ``payload`` through ``to_jsonable`` as strict JSON."""
    with open(path, "w") as f:
        json.dump(to_jsonable(payload), f, indent=indent, allow_nan=False)
