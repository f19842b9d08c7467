"""A small format-pattern engine for dataset file layouts.

Dataset layouts describe files with Python format strings like
``'{type}/{pass}/{scene}/frame_{idx:04d}.png'``. The reference framework uses
the third-party ``parse`` library to invert such patterns
(src/data/dataset.py:208); that library is not a dependency, so this module
implements the needed subset natively:

- ``to_glob(pattern)`` — turn a pattern into a glob for candidate discovery,
- ``FormatPattern.match(text)`` — invert a pattern into field values
  (``d``-typed fields become ints, untyped fields match lazily),
- formatting stays plain ``str.format``.

Supported field specs: ``{name}``, ``{name:d}``, ``{name:0Nd}``, ``{name:Nd}``
and positional ``{}`` / ``{:d}`` variants.
"""

import re
from string import Formatter

_SPEC_INT = re.compile(r"^0?(\d*)d$")


def _iter_fields(pattern):
    """Yield (literal, field_name_or_None, spec) parts of a format pattern."""
    for literal, field, spec, conversion in Formatter().parse(pattern):
        yield literal, field, spec or ""


def to_glob(pattern):
    """Replace every format field with ``*`` to get a filesystem glob."""
    out = []
    for literal, field, _ in _iter_fields(pattern):
        out.append(literal)
        if field is not None:
            out.append("*")
    return "".join(out)


class FormatPattern:
    """Compiled inverse of a format pattern.

    ``match`` returns a dict mapping field names to parsed values (ints for
    ``d``-typed fields), or None if the text doesn't fit the pattern.
    Positional fields get auto-generated integer keys ``0, 1, ...`` exposed
    via ``positional_fields``.
    """

    def __init__(self, pattern):
        self.pattern = pattern
        self.named_fields = []
        self.positional_fields = []
        self._int_fields = set()

        regex = ["^"]
        auto = 0
        for literal, field, spec in _iter_fields(pattern):
            regex.append(re.escape(literal))
            if field is None:
                continue

            if field == "":
                key, group = auto, f"_p{auto}"
                self.positional_fields.append(auto)
                auto += 1
            else:
                key, group = field, field
                if field not in self.named_fields:
                    self.named_fields.append(field)

            m = _SPEC_INT.match(spec)
            if m:
                self._int_fields.add(key)
                width = m.group(1)
                body = rf"[-+]?\d{{{width},}}" if width else r"[-+]?\d+"
            elif spec:
                raise ValueError(f"unsupported format spec '{spec}' in pattern '{pattern}'")
            else:
                body = r".+?"

            # a field may appear multiple times; later occurrences backreference
            if f"(?P<{group}>" in "".join(regex):
                regex.append(rf"(?P={group})")
            else:
                regex.append(rf"(?P<{group}>{body})")

        regex.append("$")
        self._re = re.compile("".join(regex))

    def match(self, text):
        m = self._re.match(str(text))
        if m is None:
            return None

        out = {}
        for field in self.named_fields:
            v = m.group(field)
            out[field] = int(v) if field in self._int_fields else v
        for i in self.positional_fields:
            v = m.group(f"_p{i}")
            out[i] = int(v) if i in self._int_fields else v
        return out
