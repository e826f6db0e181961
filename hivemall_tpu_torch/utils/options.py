"""Option-string parsing for trainer/function options.

Every reference trainer takes a commons-cli style option string, e.g.
``train_arow(features, label, '-r 0.1 -mix host1,host2')``
(ref: core/.../UDTFWithOptions.java:90-124). This module reproduces that
surface: each learner declares `Option`s, user passes one string, `-help`
raises with an auto-generated usage message (ref: UDTFWithOptions.java:99-118).
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class HelpRequested(Exception):
    """Raised when the option string contains -help; message is the usage text."""


class OptionError(ValueError):
    pass


@dataclass
class Option:
    name: str
    long_name: Optional[str] = None
    has_arg: bool = False
    help: str = ""
    default: Any = None
    type: Callable[[str], Any] = str


@dataclass
class Options:
    """A minimal commons-cli Options/CommandLine equivalent."""

    opts: List[Option] = field(default_factory=list)

    def add(
        self,
        name: str,
        long_name: Optional[str] = None,
        has_arg: bool = False,
        help: str = "",
        default: Any = None,
        type: Callable[[str], Any] = str,
    ) -> "Options":
        self.opts.append(Option(name, long_name, has_arg, help, default, type))
        return self

    def usage(self, func_name: str = "") -> str:
        lines = [f"usage: {func_name} [options]"]
        for o in self.opts:
            names = f"-{o.name}" + (f",--{o.long_name}" if o.long_name else "")
            arg = " <arg>" if o.has_arg else ""
            lines.append(f"  {names}{arg}  {o.help}")
        return "\n".join(lines)

    def parse(self, option_string: Optional[str], func_name: str = "") -> "CommandLine":
        by_name: Dict[str, Option] = {}
        for o in self.opts:
            by_name[o.name] = o
            if o.long_name:
                by_name[o.long_name] = o
        values: Dict[str, Any] = {}
        tokens = shlex.split(option_string) if option_string else []
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            if tok in ("-help", "--help", "-h"):
                raise HelpRequested(self.usage(func_name))
            if not tok.startswith("-"):
                raise OptionError(f"unexpected token {tok!r} in options {option_string!r}")
            key = tok.lstrip("-")
            opt = by_name.get(key)
            if opt is None:
                raise OptionError(f"unknown option {tok!r}\n{self.usage(func_name)}")
            if opt.has_arg:
                i += 1
                if i >= len(tokens):
                    raise OptionError(f"option {tok!r} requires an argument")
                values[opt.name] = opt.type(tokens[i])
            else:
                values[opt.name] = True
            i += 1
        return CommandLine(values, {o.name: o for o in self.opts})


@dataclass
class CommandLine:
    values: Dict[str, Any]
    specs: Dict[str, Option]

    def has(self, name: str) -> bool:
        return name in self.values

    def get(self, name: str, default: Any = None) -> Any:
        if name in self.values:
            return self.values[name]
        spec = self.specs.get(name)
        if default is not None:
            return default
        return spec.default if spec is not None else None

    def get_float(self, name: str, default: Optional[float] = None) -> Optional[float]:
        v = self.get(name, default)
        return None if v is None else float(v)

    def get_int(self, name: str, default: Optional[int] = None) -> Optional[int]:
        v = self.get(name, default)
        return None if v is None else int(v)
