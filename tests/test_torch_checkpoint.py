"""The port's checkpoint of streaming state (nx_signal_tpu_torch/io/
checkpoint.py), case by case after tests/test_checkpoint.py: a bitwise
round trip, nested structures, an atomic overwrite, and a resume in the
same process and in a fresh one that imports no JAX, each bitwise equal to
the uninterrupted run (the port's chunk work on the CPU depends only on
the chunk's shape, state and samples; the FFT paths included). The
container is the JAX package's: the same `leaf_<i>` arrays, in the same
order, and the same `meta` for the same state.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.io.checkpoint import load_state as jax_load_state
from nx_signal_tpu.io.checkpoint import save_state as jax_save_state
from nx_signal_tpu_torch.io.checkpoint import load_state, save_state
from nx_signal_tpu_torch.ops.windows import hann
from nx_signal_tpu_torch.parallel.streaming import (
    StreamingFIR,
    StreamingIIR,
    StreamingISTFT,
    StreamingSTFT,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_chunks(proc, state, chunks):
    outs = []
    for c in chunks:
        state, out = proc.process(state, c)
        outs.append(out.numpy())
    return state, outs


class TestSaveLoad:
    def test_roundtrip_bitwise_array(self, tmp_path):
        path = str(tmp_path / "st.npz")
        state = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 7)).astype(np.float32))
        save_state(path, state, meta={"step": 42})
        got, meta = load_state(path)
        assert meta == {"step": 42}
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(state.numpy(), got)

    def test_roundtrip_nested_structure(self, tmp_path):
        path = str(tmp_path / "st.npz")
        state = {
            "fir": torch.arange(6, dtype=torch.float32),
            "iir": (torch.zeros((2, 4, 2), dtype=torch.float64),
                    torch.ones((3,), dtype=torch.complex64)),
            "step": torch.tensor(7),
            "lists": [np.arange(3), None, 2.5],
        }
        save_state(path, state)
        got, meta = load_state(path)
        assert meta == {}
        assert set(got) == {"fir", "iir", "step", "lists"}
        np.testing.assert_array_equal(got["fir"], np.arange(6, dtype=np.float32))
        assert isinstance(got["iir"], tuple) and got["iir"][1].dtype == np.complex64
        assert got["iir"][0].dtype == np.float64 and got["iir"][0].shape == (2, 4, 2)
        assert int(got["step"]) == 7
        assert isinstance(got["lists"], list) and got["lists"][1] is None
        np.testing.assert_array_equal(got["lists"][0], np.arange(3))
        assert float(got["lists"][2]) == 2.5

    def test_conjugate_and_negative_views(self, tmp_path):
        path = str(tmp_path / "st.npz")
        z = torch.tensor([1 + 2j, -3 - 0.5j], dtype=torch.complex64)
        save_state(path, [z.conj(), torch.tensor([1.0, -2.0])._neg_view()])
        got, _ = load_state(path)
        np.testing.assert_array_equal(got[0], np.conj(z.numpy()))
        np.testing.assert_array_equal(got[1], np.array([-1.0, 2.0], np.float32))

    def test_unknown_node_raises(self, tmp_path):
        with pytest.raises(TypeError, match="cannot checkpoint"):
            save_state(str(tmp_path / "st.npz"), {"x": object()})

    def test_atomic_overwrite(self, tmp_path):
        path = str(tmp_path / "st.npz")
        save_state(path, torch.zeros(4, dtype=torch.float64), meta={"step": 1})
        save_state(path, torch.ones(4, dtype=torch.float64), meta={"step": 2})
        got, meta = load_state(path)
        assert meta["step"] == 2
        np.testing.assert_array_equal(got, np.ones(4, np.float64))
        assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]

    def test_same_leaves_and_meta_as_the_jax_container(self, tmp_path):
        rng = np.random.default_rng(1)
        arrays = {"b": rng.normal(size=(2, 3)).astype(np.float32),
                  "a": (rng.normal(size=4), rng.normal(size=2).astype(np.complex64))}
        port, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
        save_state(port, {"b": torch.from_numpy(arrays["b"]),
                          "a": tuple(torch.from_numpy(a) for a in arrays["a"])},
                   meta={"step": 3})
        jax_save_state(jax_path, {"b": jnp.asarray(arrays["b"]),
                                  "a": tuple(jnp.asarray(a) for a in arrays["a"])},
                       meta={"step": 3})
        with np.load(port) as p, np.load(jax_path) as j:
            leaves = sorted(k for k in p.files if k.startswith("leaf_"))
            assert leaves == sorted(k for k in j.files if k.startswith("leaf_"))
            for k in leaves + ["meta"]:
                assert p[k].dtype == j[k].dtype
                np.testing.assert_array_equal(p[k], j[k])
        got, want = load_state(port), jax_load_state(jax_path)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0]["a"][1], want[0]["a"][1])


class TestResumeInProcess:
    """Same-process resume: save at the midpoint, reload, continue -
    bitwise-equal tails for every processor."""

    @pytest.mark.parametrize("make", [
        lambda: StreamingFIR(np.random.default_rng(1).normal(size=33).astype(np.float32)),
        lambda: StreamingIIR(torch.tensor([
            [0.2, 0.4, 0.2, 1.0, -0.5, 0.25],
            [0.1, 0.2, 0.1, 1.0, -0.3, 0.1],
        ])),
    ], ids=["fir", "iir"])
    def test_fir_iir_bitwise(self, make, tmp_path):
        proc = make()
        rng = np.random.default_rng(2)
        chunks = [torch.from_numpy(rng.normal(size=512).astype(np.float32)) for _ in range(6)]
        _, full = _run_chunks(proc, proc.init_state(device="cpu"), chunks)
        state, _ = _run_chunks(proc, proc.init_state(device="cpu"), chunks[:3])
        path = str(tmp_path / "mid.npz")
        save_state(path, state, meta={"chunk": 3})
        restored, meta = load_state(path)
        assert meta["chunk"] == 3
        _, tail = _run_chunks(proc, restored, chunks[3:])
        for got, want in zip(tail, full[3:]):
            np.testing.assert_array_equal(got, want)

    def test_stft_istft_roundtrip_after_resume(self, tmp_path):
        w = hann(64, device="cpu")
        stft_p, istft_p = StreamingSTFT(w, hop=16), StreamingISTFT(w, hop=16)
        rng = np.random.default_rng(3)
        chunks = [torch.from_numpy(rng.normal(size=256).astype(np.float32)) for _ in range(6)]
        _, zs_full = _run_chunks(stft_p, stft_p.init_state(device="cpu"), chunks)
        zs_full = [torch.from_numpy(z) for z in zs_full]
        _, ys_full = _run_chunks(istft_p, istft_p.init_state(device="cpu"), zs_full)

        st_s, _ = _run_chunks(stft_p, stft_p.init_state(device="cpu"), chunks[:3])
        st_i, _ = _run_chunks(istft_p, istft_p.init_state(device="cpu"), zs_full[:3])
        p1, p2 = str(tmp_path / "s.npz"), str(tmp_path / "i.npz")
        save_state(p1, st_s)
        save_state(p2, st_i)
        rs, ri = load_state(p1)[0], load_state(p2)[0]
        assert ri.dtype == np.complex64
        _, zs_tail = _run_chunks(stft_p, rs, chunks[3:])
        _, ys_tail = _run_chunks(istft_p, ri, [torch.from_numpy(z) for z in zs_tail])
        for got, want in zip(zs_tail + ys_tail, [z.numpy() for z in zs_full[3:]] + ys_full[3:]):
            np.testing.assert_array_equal(got, want)


RESUME_SCRIPT = r"""
import sys
import numpy as np
import torch
from nx_signal_tpu_torch.io.checkpoint import load_state
from nx_signal_tpu_torch.parallel.streaming import StreamingFIR, StreamingISTFT
from nx_signal_tpu_torch.ops.windows import hann

ckpt, zs_path, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
proc = StreamingFIR(np.random.default_rng(1).normal(size=33).astype(np.float32))
rng = np.random.default_rng(2)
chunks = [torch.from_numpy(rng.normal(size=512).astype(np.float32)) for _ in range(6)]
saved, meta = load_state(ckpt)
assert meta["chunk"] == 3, meta
state, outs = saved["fir"], []
for c in chunks[3:]:
    state, out = proc.process(state, c)
    outs.append(out.numpy())
istft = StreamingISTFT(hann(64, device='cpu'), hop=16)
zs = np.load(zs_path)
s, ys = saved["istft"], []
for z in zs:
    s, y = istft.process(s, torch.from_numpy(z))
    ys.append(y.numpy())
np.savez(out_path, fir=np.concatenate(outs), istft=np.stack(ys))
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "nx_signal_tpu" or m.startswith("nx_signal_tpu.")]
print("RESUME_OK")
"""


class TestResumeFreshProcess:
    def test_resume_across_process_restart(self, tmp_path):
        """Restore in a fresh process that imports no JAX: bitwise
        continuation of a FIR and an ISTFT against the uninterrupted run."""
        proc = StreamingFIR(np.random.default_rng(1).normal(size=33).astype(np.float32))
        rng = np.random.default_rng(2)
        chunks = [torch.from_numpy(rng.normal(size=512).astype(np.float32)) for _ in range(6)]
        _, full = _run_chunks(proc, proc.init_state(device="cpu"), chunks)
        state, _ = _run_chunks(proc, proc.init_state(device="cpu"), chunks[:3])

        istft = StreamingISTFT(hann(64, device="cpu"), hop=16)
        zs = (rng.normal(size=(6, 8, 64)) + 1j * rng.normal(size=(6, 8, 64))).astype(np.complex64)
        _, ys_full = _run_chunks(istft, istft.init_state(device="cpu"),
                                 [torch.from_numpy(z) for z in zs])
        st_i, _ = _run_chunks(istft, istft.init_state(device="cpu"),
                              [torch.from_numpy(z) for z in zs[:3]])

        ckpt = str(tmp_path / "mid.npz")
        save_state(ckpt, {"fir": state, "istft": st_i}, meta={"chunk": 3})
        zs_path, out_path = str(tmp_path / "zs.npy"), str(tmp_path / "tail.npz")
        np.save(zs_path, zs[3:])
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        res = subprocess.run([sys.executable, "-c", RESUME_SCRIPT, ckpt, zs_path, out_path],
                             env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
        assert res.returncode == 0, res.stdout + res.stderr
        assert "RESUME_OK" in res.stdout
        with np.load(out_path) as tail:
            np.testing.assert_array_equal(tail["fir"], np.concatenate(full[3:]))
            np.testing.assert_array_equal(tail["istft"], np.stack(ys_full[3:]))
