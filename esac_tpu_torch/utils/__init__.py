"""Numerical and device helpers, checkpoints (``checkpoint``) and fenced
timers (``profiling``) shared by the port's modules."""
