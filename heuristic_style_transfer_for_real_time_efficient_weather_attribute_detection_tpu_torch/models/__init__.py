"""Model families of the port: ``pmg`` and ``rtm``.  ``pm`` is queued in
ROADMAP.md (queue A)."""

from __future__ import annotations

from . import pmg, rtm

FAMILIES = {"pmg": pmg, "rtm": rtm}
_QUEUED = {"pm": "ROADMAP.md A13 (PM family)"}


def get_family(name: str):
    key = name.lower()
    if key in _QUEUED:
        raise NotImplementedError(
            f"model family {name!r} is not ported to PyTorch yet: {_QUEUED[key]}"
        )
    try:
        return FAMILIES[key]
    except KeyError:
        raise ValueError(f"unknown model family {name!r}; choose from {sorted(FAMILIES)}")
