"""Hierarchical config loader (hydra-style groups + dotted overrides), yaml-free.

Counterpart of bnv_fusion_tpu/config.py:25-190.  The machines the port runs
on may lack PyYAML, so this module carries a small reader for the subset of
YAML that ``configs/`` uses: block maps and lists, flow lists, plain and
quoted scalars with YAML 1.1 resolution (as ``yaml.safe_load`` resolves
them), comments and ``null``.  On top of it sit the same ``defaults`` list,
``group=name`` swaps, ``a.b=value`` leaf overrides, ``preset=`` deep merge
and ``${key}`` interpolation as the JAX package's loader.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple


class ConfigNode(dict):
    """Dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(obj):
            if isinstance(obj, dict):
                return {k: unwrap(v) for k, v in obj.items()}
            if isinstance(obj, list):
                return [unwrap(v) for v in obj]
            return obj

        return unwrap(self)


# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

# YAML 1.1 implicit resolvers, as PyYAML's SafeLoader applies them
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT_DEC_RE = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OCT_RE = re.compile(r"^[-+]?0[0-7_]+$")
_INT_HEX_RE = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _resolve_scalar(text: str) -> Any:
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT_DEC_RE.match(text):
        return int(text.replace("_", ""))
    if _INT_HEX_RE.match(text):
        return int(text.replace("_", ""), 16)
    if _INT_OCT_RE.match(text):
        return int(text.replace("_", ""), 8)
    if _FLOAT_RE.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return text


def _unquote(text: str) -> str:
    if text[0] == '"':
        return bytes(text[1:-1], "utf-8").decode("unicode_escape")
    return text[1:-1].replace("''", "'")


def _split_flow(body: str) -> List[str]:
    """Split a flow collection body at top-level commas."""
    items, depth, quote, cur = [], 0, None, []
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append("".join(cur).strip())
            cur = []
            continue
        cur.append(ch)
    last = "".join(cur).strip()
    if last or items:
        items.append(last)
    return [i for i in items if i != ""]


def parse_scalar_or_flow(text: str) -> Any:
    """One inline YAML node: flow list/map, quoted or plain scalar."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow list: {text!r}")
        return [parse_scalar_or_flow(t) for t in _split_flow(text[1:-1])]
    if text.startswith("{"):
        if not text.endswith("}"):
            raise ValueError(f"unterminated flow map: {text!r}")
        out = {}
        for item in _split_flow(text[1:-1]):
            k, v = _split_key(item)
            out[k] = parse_scalar_or_flow(v)
        return out
    if text[:1] in ("'", '"'):
        return _unquote(text)
    return _resolve_scalar(text)


def _strip_comment(line: str) -> str:
    """Drop a trailing ``# comment`` that sits outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " \t:[,{-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(content: str) -> Tuple[str, str]:
    """``key: rest`` -> (key, rest); raises when the line is no mapping entry."""
    if content[:1] in ("'", '"'):
        end = content.index(content[0], 1)
        key, rest = _unquote(content[:end + 1]), content[end + 1:]
        if not rest.lstrip().startswith(":"):
            raise ValueError(f"not a mapping entry: {content!r}")
        return key, rest.lstrip()[1:].strip()
    m = re.match(r"^([^:#]+?)\s*:(?:\s+|$)(.*)$", content)
    if not m:
        raise ValueError(f"not a mapping entry: {content!r}")
    return m.group(1), m.group(2)


def _is_map_entry(content: str) -> bool:
    try:
        _split_key(content)
        return True
    except ValueError:
        return False


def _parse_block(lines: List[Tuple[int, str]], i: int, indent: int):
    """Parse the block starting at ``lines[i]`` with indentation ``indent``.

    Returns (node, next_index)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out_list: List[Any] = []
        while i < len(lines) and lines[i][0] == indent and \
                (lines[i][1].startswith("- ") or lines[i][1] == "-"):
            rest = lines[i][1][1:].strip()
            i += 1
            if rest == "":
                if i < len(lines) and lines[i][0] > indent:
                    node, i = _parse_block(lines, i, lines[i][0])
                else:
                    node = None
                out_list.append(node)
            elif _is_map_entry(rest) and not rest.startswith(("[", "{")):
                # "- key: value" opens a map whose further keys sit deeper
                sub = [(indent + 2, rest)]
                while i < len(lines) and lines[i][0] > indent:
                    sub.append(lines[i])
                    i += 1
                node, _ = _parse_block(sub, 0, indent + 2)
                out_list.append(node)
            else:
                out_list.append(parse_scalar_or_flow(rest))
        return out_list, i

    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        key, rest = _split_key(lines[i][1])
        i += 1
        if rest == "":
            nested = i < len(lines) and (
                lines[i][0] > indent or
                (lines[i][0] == indent and lines[i][1].startswith("-")))
            if nested:
                out[key], i = _parse_block(lines, i, lines[i][0])
            else:
                out[key] = None
        else:
            out[key] = parse_scalar_or_flow(rest)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at: {lines[i][1]!r}")
    return out, i


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset used by ``configs/`` (see module docstring)."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tab indentation is not supported")
        content = _strip_comment(raw)
        if content.strip() == "" or content.strip() in ("---", "..."):
            continue
        lines.append((len(content) - len(content.lstrip()), content.strip()))
    if not lines:
        return None
    if len(lines) == 1 and not _is_map_entry(lines[0][1]) and \
            not lines[0][1].startswith("-"):
        return parse_scalar_or_flow(lines[0][1])
    node, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unparsed trailing content: {lines[i][1]!r}")
    return node


# ---------------------------------------------------------------------------
# composition (bnv_fusion_tpu/config.py:56-190)
# ---------------------------------------------------------------------------

def _parse_value(text: str) -> Any:
    """Parse an override value with YAML semantics (int/float/bool/list/str)."""
    try:
        return parse_scalar_or_flow(text)
    except ValueError:
        return text


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.:]+)\}")


def _interpolate(obj: Any, root: Dict[str, Any]) -> Any:
    if isinstance(obj, str):
        def repl(m):
            node: Any = root
            for part in m.group(1).split("."):
                if isinstance(node, dict) and part in node:
                    node = node[part]
                else:
                    return m.group(0)  # leave unresolved
            return str(node)

        return _INTERP_RE.sub(repl, obj)
    if isinstance(obj, dict):
        return {k: _interpolate(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_interpolate(v, root) for v in obj]
    return obj


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        data = parse_yaml(f.read())
    return data or {}


def default_config_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs")


def load_config(overrides: Optional[List[str]] = None,
                config_dir: Optional[str] = None,
                config_name: str = "config.yaml") -> ConfigNode:
    """Compose the root config with group defaults and CLI overrides.

    ``overrides`` entries are either ``group=groupfile`` (whole-group swap,
    when ``configs/<group>/<groupfile>.yaml`` exists) or ``a.b=value`` leaf
    sets; ``preset=<name>`` deep-merges a cross-group preset over the
    composed tree before the leaf sets.
    """
    overrides = list(overrides or [])
    config_dir = config_dir or default_config_dir()

    root = load_yaml(os.path.join(config_dir, config_name))
    defaults = root.pop("defaults", [])

    group_choice: Dict[str, Optional[str]] = {}
    for item in defaults:
        if isinstance(item, dict):
            (group, choice), = item.items()
        else:
            group, choice = str(item), None
        if choice in (None, "null"):
            group_choice[group] = None
        else:
            group_choice[group] = str(choice).replace(".yaml", "")

    leaf_overrides: List[tuple] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got: {ov}")
        key, _, value = ov.partition("=")
        if "." not in key and os.path.exists(
                os.path.join(config_dir, key, value.replace(".yaml", "") + ".yaml")):
            group_choice[key] = value.replace(".yaml", "")
        else:
            leaf_overrides.append((key, _parse_value(value)))

    cfg: Dict[str, Any] = copy.deepcopy(root)
    preset_cfg: Optional[Dict[str, Any]] = None
    for group, choice in group_choice.items():
        if choice is None:
            continue
        group_cfg = load_yaml(os.path.join(config_dir, group, choice + ".yaml"))
        if group == "preset":
            preset_cfg = group_cfg
            continue
        cfg[group] = group_cfg
    if preset_cfg is not None:
        _deep_merge(cfg, preset_cfg)
        cfg["preset"] = group_choice.get("preset")

    for key, value in leaf_overrides:
        _set_dotted(cfg, key, value)

    for _ in range(5):
        new_cfg = _interpolate(cfg, cfg)
        if new_cfg == cfg:
            break
        cfg = new_cfg
    return ConfigNode.wrap(cfg)


def config_from_dict(data: Dict[str, Any]) -> ConfigNode:
    """A config tree from a plain dict (deep-copied), no yaml involved."""
    return ConfigNode.wrap(copy.deepcopy(data))
