"""Checkpoint/resume of streaming carry state (counterpart of
nx_signal_tpu/io/checkpoint.py).

The streaming processors (parallel/streaming.py) carry their whole stream
summary as an explicit state, so recovery is: save that state at a chunk
boundary, restore it in a fresh process, go on. The container is the JAX
package's: one .npz with the flattened leaves as `leaf_<i>` arrays and a
JSON `meta` dict (step counter, user tags). The structure is JSON too
(`structure`), not a pickled JAX treedef: nested dicts, lists and tuples
and None, with tensors, numpy arrays and Python scalars as leaves, dicts
flattened in sorted key order as JAX flattens them. Writes are atomic (a
temporary file, fsync, os.replace), so a crash mid-write never corrupts
the previous checkpoint.
"""

import io
import json
import os

import numpy as np
import torch

__all__ = ["save_state", "load_state"]


def _leaf(x) -> np.ndarray:
    """A leaf as a host numpy array: a tensor through detach / cpu (a
    conjugate or negative view resolved first), anything else through
    np.asarray."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def _flatten(node, leaves):
    """The JSON structure of `node`, its leaves appended to `leaves`."""
    if node is None:
        return {"t": "none"}
    if isinstance(node, dict):
        keys = sorted(node)
        for k in keys:
            if not isinstance(k, (str, int, float, bool)):
                raise TypeError(f"checkpoint dict keys must be str, int, float or bool, "
                                f"got {type(k).__name__}")
        return {"t": "dict", "k": keys, "c": [_flatten(node[k], leaves) for k in keys]}
    if isinstance(node, (list, tuple)):
        return {"t": "list" if isinstance(node, list) else "tuple",
                "c": [_flatten(c, leaves) for c in node]}
    if isinstance(node, (torch.Tensor, np.ndarray, np.generic, int, float, complex, bool)):
        leaves.append(_leaf(node))
        return {"t": "leaf"}
    raise TypeError(f"cannot checkpoint a {type(node).__name__}: leaves are tensors, numpy "
                    "arrays or Python scalars, nodes dicts, lists, tuples or None")


def _unflatten(spec, leaves):
    kind = spec["t"]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(leaves)
    children = [_unflatten(c, leaves) for c in spec["c"]]
    if kind == "dict":
        return dict(zip(spec["k"], children))
    return children if kind == "list" else tuple(children)


def _bytes_array(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8).copy()


def save_state(path, state, *, meta=None):
    """Atomically write the carry state (a tensor, an array, or nested
    dicts, lists and tuples of them) and an optional JSON-able `meta` dict
    (e.g. {'step': n, 'sample_offset': n*chunk}) to `path`. Tensors are
    pulled to the host.

    Examples:

    >>> import tempfile, os, torch
    >>> from nx_signal_tpu_torch.io.checkpoint import load_state, save_state
    >>> p = os.path.join(tempfile.mkdtemp(), 'state.npz')
    >>> save_state(p, {'zi': torch.ones(2, 3), 'step': 7}, meta={'offset': 640})
    >>> state, meta = load_state(p)
    >>> sorted(state), state['step'], meta
    (['step', 'zi'], array(7), {'offset': 640})
    """
    leaves = []
    structure = _flatten(state, leaves)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["structure"] = _bytes_array(structure)
    payload["meta"] = _bytes_array(meta or {})
    buf = io.BytesIO()
    np.savez(buf, **payload)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_state(path):
    """Restore (state, meta_dict) written by `save_state`. Leaves come back
    as numpy arrays, dtypes and values bit-identical to what was saved; the
    streaming processors take them as they are (`process` moves a numpy
    state onto the chunk's device).

    Examples:

    >>> import tempfile, os, torch
    >>> from nx_signal_tpu_torch.io.checkpoint import load_state, save_state
    >>> p = os.path.join(tempfile.mkdtemp(), 'state.npz')
    >>> save_state(p, [torch.arange(3.0)])
    >>> state, meta = load_state(p)
    >>> state[0], meta   # numpy back, bit-identical
    (array([0., 1., 2.], dtype=float32), {})
    """
    with np.load(path) as z:
        structure = json.loads(z["structure"].tobytes().decode())
        meta = json.loads(z["meta"].tobytes().decode())
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    return _unflatten(structure, iter(leaves)), meta
