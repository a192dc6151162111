"""Shared config-dataclass plumbing.

The port's own copy of mlx_audio_tpu/base.py (`BaseModelArgs` and the
recursive `from_dict`), kept equal to it: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass
from typing import Type, TypeVar, Union, get_origin, get_type_hints

T = TypeVar("T")


@dataclass
class BaseModelArgs:
    """Base class for model config dataclasses; ignores unknown config keys."""

    @classmethod
    def from_dict(cls, params: dict):
        return cls(
            **{
                k: v
                for k, v in params.items()
                if k in inspect.signature(cls).parameters
            }
        )


def from_dict(data_class: Type[T], data: dict) -> T:
    """Recursively build a (possibly nested) dataclass from a config dict."""
    if not dataclasses.is_dataclass(data_class):
        raise TypeError(f"{data_class} is not a dataclass")
    field_types = get_type_hints(data_class)
    kwargs = {}
    for field in dataclasses.fields(data_class):
        if field.name not in data:
            continue
        value = data[field.name]
        ftype = field_types[field.name]
        origin = get_origin(ftype)
        if origin is Union:
            args = [a for a in ftype.__args__ if a is not type(None)]
            if args:
                ftype = args[0]
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            value = from_dict(ftype, value)
        kwargs[field.name] = value
    return data_class(**kwargs)
