"""Model families of the port: ``pmg``, ``pm`` and ``rtm``, as in the JAX
package."""

from __future__ import annotations

from . import pm, pmg, rtm

FAMILIES = {"pmg": pmg, "pm": pm, "rtm": rtm}


def get_family(name: str):
    try:
        return FAMILIES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown model family {name!r}; choose from {sorted(FAMILIES)}")
