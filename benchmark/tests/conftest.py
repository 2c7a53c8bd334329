"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
checkout's root. Tests that need the card carry the ``cuda`` marker and
skip inside the test where there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
