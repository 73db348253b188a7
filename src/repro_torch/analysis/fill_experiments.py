"""Print the dry-run and roofline tables -- the counterpart of
``repro.analysis.fill_experiments``, which writes them into an
``EXPERIMENTS.md`` the repository does not have; this prints them to
standard output and writes no file.

  PYTHONPATH=src python -m repro_torch.analysis.fill_experiments [DIR]

``DIR`` holds the dry run's records (default ``build/dryrun``, where
``python -m repro_torch.launch.dryrun`` writes them).
"""
from __future__ import annotations

import sys
from typing import List, Optional

from repro_torch.analysis import roofline
from repro_torch.launch import dryrun


def render(records: List[dict]) -> str:
    return ("### Dry run (one card)\n\n" + dryrun.summary_table(records)
            + "\n\n### Roofline (one card)\n\n" + roofline.render_table(records))


def main(argv: Optional[List[str]] = None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else str(dryrun.DEFAULT_OUT)
    text = render(roofline.load_records(d))
    print(text)
    return text


if __name__ == "__main__":
    main()
