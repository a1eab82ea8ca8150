"""Dynamics networks and the ICNF model."""
