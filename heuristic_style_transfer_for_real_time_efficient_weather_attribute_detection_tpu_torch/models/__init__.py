"""Model families of the port.  Only ``pmg`` is ported so far; ``pm`` and
``rtm`` are queued in ROADMAP.md (queue A, slice 4)."""

from __future__ import annotations

from . import pmg

FAMILIES = {"pmg": pmg}
_QUEUED = {"pm": "ROADMAP.md A13 (PM family)", "rtm": "ROADMAP.md A14 (RTM family)"}


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
