"""`ConfigDict`: a dict with attribute access (copy of nemo_tpu.core.config)."""

from __future__ import annotations

from typing import Any, Mapping


class ConfigDict(dict):
    """Dict with attribute access and recursive wrapping."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        merged = dict(data or {})
        merged.update(kw)
        for k, v in merged.items():
            self[k] = _wrap(v)

    def __setitem__(self, k: str, v: Any) -> None:
        super().__setitem__(k, _wrap(v))

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v


def _wrap(v: Any) -> Any:
    if isinstance(v, ConfigDict):
        return v
    if isinstance(v, Mapping):
        return ConfigDict(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_wrap(x) for x in v)
    return v
