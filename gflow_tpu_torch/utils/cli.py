"""Typed-signature CLI — a minimal stand-in for `tyro.cli` (the reference's
CLI layer, e.g. gflow/fit_video.py:409) built on argparse.

`run_cli(fn)` turns every keyword parameter of `fn` into a `--kebab-case`
flag using its annotation and default. Supports int/float/str/bool/Path/
Optional[...]/Literal[...]. Booleans get paired --flag / --no-flag switches
(tyro behavior).
"""
from __future__ import annotations

import argparse
import inspect
import typing
from pathlib import Path


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def build_parser(fn, prog=None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=prog, description=fn.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    sig = inspect.signature(fn)
    hints = typing.get_type_hints(fn)
    for name, p in sig.parameters.items():
        if p.kind not in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
            continue
        tp = hints.get(name, type(p.default) if p.default is not inspect._empty else str)
        tp, _optional = _unwrap_optional(tp)
        flag = "--" + name.replace("_", "-")
        default = None if p.default is inspect._empty else p.default
        required = p.default is inspect._empty

        if typing.get_origin(tp) is typing.Literal:
            choices = list(typing.get_args(tp))
            parser.add_argument(flag, default=default, choices=choices,
                                required=required)
        elif tp is bool:
            group = parser.add_mutually_exclusive_group(required=required)
            group.add_argument(flag, dest=name, action="store_true",
                               default=default)
            group.add_argument("--no-" + name.replace("_", "-"), dest=name,
                               action="store_false")
        elif tp in (int, float, str):
            parser.add_argument(flag, type=tp, default=default,
                                required=required)
        elif tp is Path:
            parser.add_argument(flag, type=Path, default=default,
                                required=required)
        else:
            parser.add_argument(flag, type=str, default=default,
                                required=required)
    return parser


def run_cli(fn, argv=None, prog=None):
    parser = build_parser(fn, prog=prog)
    args = parser.parse_args(argv)
    return fn(**vars(args))
