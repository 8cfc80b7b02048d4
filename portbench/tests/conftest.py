"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
root of the repository (the tests marked `cuda` run on a card and skip
elsewhere)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def with_held(spec: dict) -> dict:
    """BENCHMARK.json's `spec` with the cells held out of it added back: each
    file of portbench/held/ holds the entries of one, ready to add."""
    spec = json.loads(json.dumps(spec))
    for path in sorted((ROOT / "portbench" / "held").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            spec[key].extend(entries)
    return spec
