"""Model families of the port: ``pmg``, ``pm`` and ``rtm``, as in the JAX
package."""

from __future__ import annotations

from typing import Any, Dict, Mapping

from . import pm, pmg, rtm

FAMILIES = {"pmg": pmg, "pm": pm, "rtm": rtm}


def get_family(name: str):
    try:
        return FAMILIES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown model family {name!r}; choose from {sorted(FAMILIES)}")


def build_spec(family: str, tasks: Mapping[str, Any], hparams: Dict[str, Any]):
    return get_family(family).build_spec(tasks, hparams)
