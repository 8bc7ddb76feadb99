"""Weak-signal layer of the port: adaptive polarization (pol.py)."""
