"""Parity of the port's sharded Welch family (nx_signal_tpu_torch/parallel/
estimation.py) with the JAX package's, on the CPU.

The cases run in the gloo group of 4 CPU ranks of tests/test_torch_sharded.py
(`torch_sharded_ranks.cpu_results`: one spawn per test process, whichever
of the two files asks first); each rank returns its channel rows of the
result. They are held against the JAX sharded functions on a 4-device
slice of the conftest CPU mesh within 1e-5 of the max (f32 spectra whose
segment sums are associated differently), every block of a channel row
bitwise equal to the others; on CPU tensors kernel E's wrapper runs its
plain version and launches nothing (chip_smoke.py phase 8 counts the
launches on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nx_signal_tpu.parallel import estimation as jest
from nx_signal_tpu.parallel.mesh import make_dsp_mesh as jax_mesh

from tests import torch_sharded_ranks as ranks


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.cpu_results(tmp_path_factory)


def mesh4(shape):
    return jax_mesh(*shape, devices=jax.devices()[:4])


def rows_of(results, i, mesh_shape):
    """The global result from the ranks' channel rows, and whether the
    ranks of each channel row agree bitwise."""
    shards = [results["est", i, r] for r in range(ranks.WORLD)]
    n_channel, n_block = mesh_shape
    by_coord = {coord: p for coord, p, _ in shards}
    agree = all(by_coord[(c, b)].tobytes() == by_coord[(c, 0)].tobytes()
                for c in range(n_channel) for b in range(n_block))
    return np.concatenate([by_coord[(c, 0)] for c in range(n_channel)], axis=0), agree


@pytest.mark.parametrize("i", range(len(ranks.EST_CASES)),
                         ids=[f"{c[1]}-{c[0]}-{c[3]}" for c in ranks.EST_CASES])
def test_sharded_estimation_matches_jax(i, results):
    mesh_shape, fn, channels, length, kw = ranks.EST_CASES[i]
    kw = dict(kw)
    x, y = ranks.est_signals(channels, length, kw.pop("complex_input", False))
    jmesh = mesh4(mesh_shape)
    if fn == "welch":
        f, want = jest.sharded_welch(jnp.asarray(x), mesh=jmesh, sampling_rate=100.0, **kw)
    else:
        f, want = getattr(jest, f"sharded_{fn}")(jnp.asarray(x), jnp.asarray(y), mesh=jmesh,
                                                 sampling_rate=100.0, **kw)
    want = np.asarray(want)
    got, agree = rows_of(results, i, mesh_shape)
    assert agree
    assert got.shape == want.shape
    assert np.iscomplexobj(got) == (fn == "csd")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(results["est_freqs", i], np.asarray(f), rtol=1e-6)
    # on a CPU tensor kernel E's wrapper runs its plain version
    assert all(results["est", i, r][2] == 0 for r in range(ranks.WORLD))


@pytest.mark.parametrize("name,pattern", [
    ("est_detrend", r"invalid detrend, expected 'constant', 'linear', False, None, got"),
    ("est_channels", r"channels \(3\) must be divisible by 2")])
def test_sharded_estimation_errors(name, pattern, results):
    import re

    assert results["errors"][name] is not None and re.search(pattern, results["errors"][name])
    with pytest.raises(ValueError, match=pattern):
        if name == "est_detrend":
            jest.sharded_welch(np.zeros((4, 4096), np.float32), mesh=mesh4((1, 4)),
                               detrend=lambda f: f)
        else:
            jest.sharded_welch(np.zeros((3, 4096), np.float32), mesh=mesh4((2, 2)))
