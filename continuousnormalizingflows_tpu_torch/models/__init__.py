"""Dynamics networks and the ICNF model."""

from .icnf import ICNF, default_net
from .nets import MLP, CondLayer, DynamicsNet, Planar, from_torch, planar_h

__all__ = ["ICNF", "default_net", "MLP", "CondLayer", "DynamicsNet", "Planar", "from_torch",
           "planar_h"]
