"""Numerical and device helpers shared by the port's modules."""
