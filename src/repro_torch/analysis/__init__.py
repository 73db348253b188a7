"""Analysis of the port's runs: the profiler's record of a step
(``trace``), rooflines of dry-run cases and decode steps (``roofline``) and
their tables (``fill_experiments``)."""
