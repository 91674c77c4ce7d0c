"""Settings validation against the bundled JSON schema.

Mirrors the contract of the reference implementation's validator
(splink/validate.py:53) but validates the splink_tpu schema (shared by splink_tpu_torch,
so a settings dict or saved model is valid in both packages),
which is a superset of the reference schema (adds ``comparison`` specs and
TPU execution keys such as ``mesh`` and ``pair_batch_size``).
"""

from __future__ import annotations

import copy
import json
import warnings
from importlib import resources

from .check_types import check_types

try:
    from jsonschema import ValidationError, validate

    _HAS_JSONSCHEMA = True
except ImportError:  # pragma: no cover - jsonschema is an optional dependency
    _HAS_JSONSCHEMA = False

    class ValidationError(ValueError):  # type: ignore[no-redef]
        pass


_SCHEMA_CACHE: dict | None = None


def get_schema() -> dict:
    """Load (and cache) the settings JSON schema shipped with the package."""
    global _SCHEMA_CACHE
    if _SCHEMA_CACHE is None:
        ref = resources.files("splink_tpu_torch").joinpath("files/settings_jsonschema.json")
        _SCHEMA_CACHE = json.loads(ref.read_text())
    return _SCHEMA_CACHE


@check_types
def validate_settings(settings_dict: dict) -> None:
    """Raise ValidationError with a readable message if settings are invalid."""
    if not isinstance(settings_dict, dict):
        raise TypeError("settings must be a dict")
    if not _HAS_JSONSCHEMA:  # pragma: no cover
        warnings.warn(
            "jsonschema is not installed; the settings dictionary was not validated"
        )
        return
    try:
        validate(settings_dict, get_schema())
    except Exception as e:
        raise ValidationError(
            "There is an error in your settings dictionary.\n"
            "See splink_tpu_torch/files/settings_jsonschema.json for the full contract "
            "(keys, allowed values and defaults).\n\n"
            f"Details:\n{e}"
        ) from e


def get_default_value(key: str, is_column_setting: bool):
    """Read a default out of the schema; the schema is the single source of truth."""
    schema = get_schema()
    if is_column_setting:
        prop = schema["properties"]["comparison_columns"]["items"]["properties"][key]
    else:
        prop = schema["properties"][key]
    return copy.deepcopy(prop["default"])
