"""Auto-CLI from a function signature (a copy of `lit_llama_ja_tpu/utils/cli.py`,
the stand-in for the reference's jsonargparse usage): flags are generated from the
annotated parameters of the wrapped `main`. Pure stdlib argparse."""
from __future__ import annotations

import argparse
import inspect
import typing
from pathlib import Path
from typing import Callable, Optional


def _parse_bool(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "on")


def _base_type(annotation):
    origin = typing.get_origin(annotation)
    if origin is typing.Union:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            return _base_type(args[0])
        return str
    if annotation in (int, float, str, Path):
        return annotation
    if annotation is bool:
        return _parse_bool
    return str


def _resolve_annotations(fn) -> dict:
    """Resolve string annotations (PEP 563 `from __future__ import annotations`)."""
    target = fn.func if isinstance(fn, __import__("functools").partial) else fn
    try:
        return typing.get_type_hints(target)
    except Exception:
        return {}


def CLI(fn: Callable, args: Optional[list] = None):
    """Build an argparse CLI mirroring ``fn``'s signature and invoke it."""
    sig = inspect.signature(fn)
    hints = _resolve_annotations(fn)
    parser = argparse.ArgumentParser(
        description=(inspect.getdoc(fn) or "").split("\n\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    for name, param in sig.parameters.items():
        flag = "--" + name.replace("_", "-")
        annotation = hints.get(name, param.annotation)
        param = param.replace(annotation=annotation)
        if param.annotation is bool or isinstance(param.default, bool):
            parser.add_argument(
                flag, type=_parse_bool, default=param.default
                if param.default is not inspect.Parameter.empty else False,
            )
        else:
            kwargs = {}
            if param.annotation is not inspect.Parameter.empty:
                kwargs["type"] = _base_type(param.annotation)
            if param.default is not inspect.Parameter.empty:
                kwargs["default"] = param.default
            else:
                kwargs["required"] = True
            parser.add_argument(flag, **kwargs)
    ns = parser.parse_args(args)
    return fn(**vars(ns))
