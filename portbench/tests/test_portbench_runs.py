"""Whole runs of the harness (run.py in a fresh process) on the CPU at
small sizes: the program's plain versions, the harness's look for a card
skipped with `--device cpu`, from a copy of portbench/ whose
configurations are cut to a few rows of a few thousand samples, with the
cells held out of BENCHMARK.json (portbench/held/) added back. The
program is correct there; the control and each fault the cell can have
are not. On a card, the tests marked `cuda` run each cell at its own size."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, with_held

SPEC = with_held(json.loads((ROOT / "BENCHMARK.json").read_text()))
ONE_CHIP = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]
SHARDED = [w["name"] for w in SPEC["workloads"] if w["chips"] > 1]
SMALL = {"chain48k": (4, 8192), "roundtrip44k": (2, 8192), "chain48k_block4": (4, 16384)}
FAULTS = ["alter_answer", "half_batch", "stale_answer"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _copy(root):
    """A copy of the benchmark at `root` whose BENCHMARK.json holds the
    held cells too."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("_traces", "__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(SPEC))
    return root


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of the benchmark with every configuration cut to SMALL."""
    root = _copy(tmp_path_factory.mktemp("small"))
    for c in SPEC["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["channels"], cfg["samples"] = SMALL[c["name"]]
        path.write_text(json.dumps(cfg))
    return root


def run(root, *args, program=True, timeout=300, **environ):
    env = dict(os.environ, **environ)
    env.pop("PYTHONPATH", None)
    if program:
        env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, str(root / "portbench" / "run.py"), *args],
                          cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return proc, line


def cpu(root, cell, *extra, seconds="1", seed="4294967311"):
    proc, line = run(root, "--workload", cell, "--seed", seed, "--seconds", seconds,
                     "--device", "cpu", *extra)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    return line, proc.stderr


@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_last_line_has_the_contract_keys(small, trace):
    cell = ONE_CHIP[0]
    line, err = cpu(small, cell, "--trace", trace)
    extra = ["breakdown"] if trace == "1" else []
    assert list(line) == KEYS + extra + ["checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    kind = "per_layer" if trace == "1" else "end_to_end"
    listed = {m["name"] for m in SPEC[kind] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= listed and line["metrics"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace == "1":
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the numbers compared, each beside its limit, last on standard error too
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_a_run_with_no_card_exits_non_zero_and_prints_no_result(small):
    # the card hidden, so that the test holds on a machine that has one
    proc, line = run(small, "--workload", ONE_CHIP[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0 and line is None
    assert "CUDA device" in proc.stderr


def test_several_seeds_after_one_set_up_print_a_line_each(small):
    seeds = ["4294967311", "17"]
    proc, _ = run(small, "--workload", ONE_CHIP[0], "--seed", seeds[0], "--seconds", "1",
                  "--trace", "0", "--device", "cpu", "--seeds", ",".join(seeds))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(t) for t in proc.stdout.strip().splitlines() if t.startswith("{")]
    assert len(lines) == len(seeds)
    assert all(line["correct"] is True and line["attempted"] > 0 for line in lines)


@pytest.mark.parametrize("cell", SHARDED)
def test_each_rank_of_a_cell_on_several_cards_runs_one_host_thread(small, cell):
    _, err = cpu(small, cell)
    world = next(w["chips"] for w in SPEC["workloads"] if w["name"] == cell)
    for rank in range(world):
        assert f"rank {rank} set-up" in err
        assert [t for t in err.splitlines() if f"rank {rank} set-up" in t][0].endswith(
            ", 1 host threads")


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_traces", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for device in ("cuda", "cpu"):
        proc, line = run(tmp_path, "--workload", ONE_CHIP[0], "--seed", "1", "--seconds", "1",
                         "--trace", "0", "--device", device, program=False)
        assert proc.returncode != 0 and line is None


@pytest.mark.parametrize("cell", ONE_CHIP + SHARDED)
def test_the_program_is_correct_and_its_control_is_not(small, cell):
    line, _ = cpu(small, cell)
    assert line["correct"] is True, line["checks"]
    line, _ = cpu(small, cell, "--mode", "control")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell, fault", [(c, f) for c in ONE_CHIP + SHARDED for f in FAULTS]
                         + [(c, "no_exchange") for c in SHARDED])
def test_a_fault_underneath_makes_the_run_incorrect(small, cell, fault):
    line, _ = cpu(small, cell, "--patch", f"portbench.tests.faults:{fault}")
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CHIP + SHARDED)
def test_each_cell_runs_correct_on_the_card(card, cell, tmp_path):
    import torch

    chips = next(w["chips"] for w in SPEC["workloads"] if w["name"] == cell)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    proc, line = run(_copy(tmp_path), "--workload", cell, "--seed", "7", "--seconds", "2",
                     "--trace", "1", timeout=1500)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    assert line["correct"] is True and line["device"]["busy_s"] > 0
