"""The import guard: what the harness loads, in a fresh interpreter, holds
no module whose top-level name (the part before the first dot, compared
whole) is jax, jaxlib, flax or nx_signal_tpu; the references load nothing
of the program either."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "nx_signal_tpu")

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.core.spec import Bench
import portbench.core.runner, portbench.core.ranks, portbench.core.timeline
bench = Bench({root!r})
for kind in {kinds!r}:
    for path in sorted((bench.root / "portbench" / kind).glob("*.py")):
        bench.module(kind, path.stem)
{extra}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(kinds, extra=""):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT), kinds=kinds,
                                                              extra=extra)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_the_program_load_no_jax():
    # the program's modules that the entries import, as a run loads them
    extra = ("import nx_signal_tpu_torch.models.pipeline, nx_signal_tpu_torch.spectral.stft, "
             "nx_signal_tpu_torch.parallel.sharded, nx_signal_tpu_torch.parallel.multihost")
    found = [m for m in _loaded(("entries", "references", "stages", "metrics"), extra)
             if m.split(".")[0] in FORBIDDEN]
    assert found == []


def test_the_references_load_nothing_of_the_program():
    found = [m for m in _loaded(("references",))
             if m.split(".")[0] in FORBIDDEN + ("nx_signal_tpu_torch",)]
    assert found == []


def test_the_guard_compares_whole_top_level_names():
    from portbench.core.runner import forbidden_modules

    sys.modules.setdefault("nx_signal_tpu_torch_like", sys)
    try:
        assert "nx_signal_tpu_torch_like" not in forbidden_modules()
        sys.modules["nx_signal_tpu.fake"] = sys
        assert forbidden_modules() == ["nx_signal_tpu.fake"]
    finally:
        sys.modules.pop("nx_signal_tpu.fake", None)
        sys.modules.pop("nx_signal_tpu_torch_like", None)
