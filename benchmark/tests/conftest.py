"""The benchmark's own tests, run from the checkout's root with
``python -m pytest benchmark/tests``: here the tests marked ``cuda`` skip,
on the card they run too.  This file only puts the root on the path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

