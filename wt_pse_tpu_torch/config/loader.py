"""Three-tier configuration merge: registry defaults -> YAML overlays -> CLI
leftovers (the port's own copy of ``wt_pse_tpu/config/loader.py:14-80``).

Later sources win. CLI values are typed as YAML 1.1 plain scalars, as
``yaml.safe_load`` types them, so ``--whitening false`` and ``--margin 0.1``
get real types. The typing is done here without PyYAML (the CUDA machine may
not have it): bools, ints, floats, nulls and dates by PyYAML's own implicit
resolver patterns, quoted strings, trailing comments, and flow sequences of
those. Any other text (a mapping, an anchor, a nested sequence) stays a string. ``yaml`` is imported only by :func:`load_config`, and only when
a YAML overlay is given.
"""

from __future__ import annotations

import datetime
import re


class Config(dict):
    """A dict with attribute access, mirroring how the trainer reads hparams."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


# PyYAML's implicit resolvers for plain scalars (yaml/resolver.py, YAML 1.1)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_DATE = re.compile(r"^([0-9]{4})-([0-9]{2})-([0-9]{2})$")
# what a YAML plain scalar may not start with or contain: those texts are
# indicators, comments or mappings, and stay strings here
_NOT_PLAIN = re.compile(r"^[,\[\]{}#&*!|>'\"%@`]|^[-?:](?:\s|$)|: |:$")


def _sexagesimal(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _scalar(text: str):
    """One plain or quoted scalar, typed; text of no other type stays a string."""
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"' and "\\" not in text:
        return text[1:-1]
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    m = _DATE.match(text)
    if m:
        return datetime.date(*(int(g) for g in m.groups()))
    return text


def _parse_scalar(text: str):
    """``yaml.safe_load(text)`` for the texts a CLI value is made of; any other
    text is returned unchanged, as the JAX loader returns text that does not
    parse."""
    stripped = text.strip()
    if " #" in stripped and stripped[0] not in "'\"":  # a trailing comment
        stripped = stripped[:stripped.index(" #")].rstrip()
    if stripped.startswith("[") and stripped.endswith("]"):
        body = stripped[1:-1].strip()
        items = [t.strip() for t in body.split(",")] if body else []
        if all(t and not _NOT_PLAIN.search(t) for t in items):
            return [_scalar(t) for t in items]
        return text
    if stripped and _NOT_PLAIN.search(stripped) and stripped[0] not in "'\"":
        return text
    return _scalar(stripped)


def argv_update(cfg: dict, left_argv: list[str]) -> dict:
    """Apply leftover CLI args (``--key value`` / ``--key=value``) onto ``cfg``.

    Dotted keys update nested dicts. Unknown keys are added (sconf semantics).
    """
    i = 0
    while i < len(left_argv):
        tok = left_argv[i]
        if not tok.startswith("--"):
            i += 1
            continue
        tok = tok[2:]
        if "=" in tok:
            key, raw = tok.split("=", 1)
            i += 1
        else:
            key = tok
            if i + 1 < len(left_argv) and not left_argv[i + 1].startswith("--"):
                raw = left_argv[i + 1]
                i += 2
            else:
                raw = "true"
                i += 1
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_scalar(raw)
    return cfg


def load_config(
    default: dict | None = None,
    yaml_paths: list[str] | None = None,
    left_argv: list[str] | None = None,
) -> Config:
    """Merge ``default`` <- each YAML in order <- CLI leftovers. Later wins."""
    cfg = Config(dict(default or {}))
    if yaml_paths:
        import yaml

        for path in yaml_paths:
            with open(path, encoding="utf8") as f:
                overlay = yaml.safe_load(f) or {}
            if not isinstance(overlay, dict):
                raise ValueError(f"config overlay {path} is not a mapping")
            cfg.update(overlay)
    if left_argv:
        argv_update(cfg, list(left_argv))
    return cfg
