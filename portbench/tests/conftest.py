"""The benchmark's own tests (CPU; a test that needs the card is marked
``cuda`` and skips without one). Run from the repository root:

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
