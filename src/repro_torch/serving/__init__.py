"""Continuous-batching serving (port of ``repro.serving``)."""
