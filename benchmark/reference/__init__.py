"""The plain reference: the discretisation worked out again from the
configuration's numbers, in plain PyTorch and NumPy. It imports nothing of
the program and takes nothing the program has made."""

from __future__ import annotations

__all__ = ["make"]


def make(config: dict, params: dict, device):
    """The reference of a configuration file's ``reference`` kind, built
    from the cell's parameters."""
    kind = config["reference"]
    if kind == "tank":
        from .tank import TankReference
        return TankReference(params, device)
    if kind == "cylinder":
        if params.get("lateral", "incident") != "incident":
            raise ValueError("the reference relaxes the lateral zone toward "
                             "the incident wave")
        from .cylinder import CylinderReference
        return CylinderReference(params, device)
    raise ValueError(f"unknown reference {kind!r}")
