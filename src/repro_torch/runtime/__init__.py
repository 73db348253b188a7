"""Load-time plan and kernel dispatch (port of ``repro.runtime``)."""
