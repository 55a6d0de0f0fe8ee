"""ONE registry for every PANDORA_* runtime flag (routing, remat, bench).

Round-4 verdict item: 12+ env vars read at trace time deep inside modules
controlled numerics and kernel routing with no single source of truth, so
reproducing "what exactly did the bench run?" required knowing the env.
This module is that source of truth:

  - every flag is DECLARED here with its default, type, and effect;
  - library code asks `flags.flag("PANDORA_X")` instead of touching
    `os.environ` (grep for os.environ under models/ and ops/ should find
    only this shim);
  - programmatic override wins over the environment
    (`flags.set_flag(...)` / the `flags.overridden(...)` context manager),
    so configs/tests don't have to mutate the process env;
  - `flags.snapshot()` returns the full effective set — bench.py embeds it
    in its JSON so every recorded number names its routing.

Environment values parse as: bools — "", "0", "false", "off", "no" are
False, anything else True; ints/strs — literal. Flags are read at TRACE
time: changing one after a function is jit-compiled has no effect on the
cached executable.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator


@dataclass(frozen=True)
class FlagSpec:
    name: str
    kind: str          # "bool" | "int" | "str"
    default: Any
    doc: str


_SPECS = [
    # -- layout choices (trace-time)
    FlagSpec("PANDORA_DISABLE_TCONV_DOT", "bool", False,
             "Use the lax.conv temporal conv instead of the three shifted "
             "t-axis matmuls (models/unet3d.py _TConv3)."),
    # -- training-graph switches
    FlagSpec("PANDORA_FINE_REMAT", "bool", False,
             "Nested per-attention/per-FF remat inside spatial transformer "
             "blocks during TRAINING (576x1024 memory relief; changes the "
             "autodiff graph, never inference)."),
    # -- process/bench controls (read at startup, not trace time)
    FlagSpec("PANDORA_CKPT_DIR", "str", "",
             "Checkpoint directory override for pipeline entrypoints."),
    FlagSpec("PANDORA_CLIP_BPE", "str", "",
             "Path to a CLIP BPE merges file (pipeline/tokenizers.py)."),
    FlagSpec("PANDORA_BENCH_FAST", "bool", False,
             "bench.py: headline phases only (skip configs 3/4)."),
]

REGISTRY: Dict[str, FlagSpec] = {s.name: s for s in _SPECS}

_overrides: Dict[str, Any] = {}


def _parse(spec: FlagSpec, raw: str) -> Any:
    if spec.kind == "bool":
        return raw.strip().lower() not in ("", "0", "false", "off", "no")
    if spec.kind == "int":
        try:
            return int(raw)
        except ValueError:
            return spec.default
    return raw


def flag(name: str) -> Any:
    """Effective value: programmatic override > environment > default."""
    spec = REGISTRY[name]
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(name)
    if raw is None:
        return spec.default
    return _parse(spec, raw)


def set_flag(name: str, value: Any) -> None:
    if name not in REGISTRY:
        raise KeyError(f"undeclared flag {name!r} — add it to "
                       "core/flags.py REGISTRY")
    _overrides[name] = value


def clear_flag(name: str) -> None:
    _overrides.pop(name, None)


@contextlib.contextmanager
def overridden(**kv: Any) -> Iterator[None]:
    """Scoped overrides (keys without the PANDORA_ prefix are accepted)."""
    full = {k if k.startswith("PANDORA_") else "PANDORA_" + k: v
            for k, v in kv.items()}
    saved = {k: _overrides.get(k, _MISSING) for k in full}
    try:
        for k, v in full.items():
            set_flag(k, v)
        yield
    finally:
        for k, v in saved.items():
            if v is _MISSING:
                _overrides.pop(k, None)
            else:
                _overrides[k] = v


_MISSING = object()


def snapshot(only_non_default: bool = True) -> Dict[str, Any]:
    """The effective flag set (for embedding in bench/eval records)."""
    out = {}
    for name, spec in REGISTRY.items():
        v = flag(name)
        if only_non_default and v == spec.default:
            continue
        out[name] = v
    return out


def table() -> str:
    """Markdown table of every flag (README / PERF.md documentation)."""
    rows = ["| flag | type | default | effect |", "|---|---|---|---|"]
    for s in _SPECS:
        rows.append(f"| `{s.name}` | {s.kind} | `{s.default!r}` | {s.doc} |")
    return "\n".join(rows)


if __name__ == "__main__":  # pragma: no cover
    print(table())
