"""The dense decoder on the paged pool (port of ``repro.models``)."""
