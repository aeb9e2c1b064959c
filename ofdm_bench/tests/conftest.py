"""The benchmark's CPU tests: ``python -m pytest ofdm_bench/tests`` from
the root of the repository.  Nothing here needs a card; a test that would
carries the ``cuda`` marker and skips without one."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
