"""On-disk cache of cold-path graph views (ELL packings, tilings, ...).

Counterpart of custom_op_benchmark_tpu/graph/cache.py. The reference
caches its generated index tensors so that repeated runs skip the Python
construction loops (wrapper.py:84, 114-116); here the expensive cold paths
are ELL packing, block-sparse tiling, reordering and component labelling
at ogbn scales. Usage::

    g = from_coo(src, dst, n)
    se, de = cached(g, "ell_dual", lambda: ell_dual(g))

An entry is two files: an ``.npz`` of the view's arrays (every tensor and
numpy array in it) and a ``.tree`` pickle of the rest (its dataclasses,
lists, tuples, dicts and plain fields, with each array replaced by its
index). Entries are keyed by a content hash of the graph's ``src``/``dst``
and the view's kind and parameters, so a changed graph can never read a
stale entry. Tensors come back on the graph's device. Set
``COB_CACHE_DIR`` or pass ``cache_dir``; the default is
``~/.cache/custom_op_benchmark_tpu_torch``. Unpickling can run code, so an
entry is loaded only from a directory that this user owns and that no
group or other user can write to; elsewhere the view is rebuilt.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import zipfile
from typing import Callable, List, TypeVar

import numpy as np
import torch

T = TypeVar("T")

# What a damaged or foreign entry raises while it loads: it is rebuilt.
_LOAD_ERRORS = (OSError, EOFError, ValueError, KeyError, TypeError,
                AttributeError, pickle.UnpicklingError, zipfile.BadZipFile)


def _default_dir() -> str:
    return os.environ.get(
        "COB_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "custom_op_benchmark_tpu_torch"))


def _dir_is_trusted(d: str) -> bool:
    """Owned by this user and not group- or world-writable."""
    try:
        st = os.stat(d)
    except OSError:
        return False
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        return False
    return not st.st_mode & 0o022


def graph_key(g, extra: str = "") -> str:
    """Content hash of a Graph's edge structure (and a view tag)."""
    h = hashlib.sha256()
    h.update(g.src.cpu().numpy().tobytes())
    h.update(g.dst.cpu().numpy().tobytes())
    h.update(f"{g.n_nodes}:{g.n_edges}:{extra}".encode())
    return h.hexdigest()[:24]


@dataclasses.dataclass(frozen=True)
class _Array:
    """Where an array of the view went: its index in the ``.npz``."""
    index: int
    tensor: bool


@dataclasses.dataclass(frozen=True)
class _Record:
    """A dataclass of the view: its class and its fields' skeletons."""
    cls: type
    fields: dict


def _split(obj, arrays: List[np.ndarray]):
    """The skeleton of ``obj`` with its arrays moved into ``arrays``."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        is_tensor = isinstance(obj, torch.Tensor)
        arrays.append(obj.detach().cpu().numpy() if is_tensor else obj)
        return _Array(len(arrays) - 1, is_tensor)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _Record(type(obj), {f.name: _split(getattr(obj, f.name),
                                                  arrays)
                                   for f in dataclasses.fields(obj)})
    if type(obj) in (list, tuple):
        return type(obj)(_split(o, arrays) for o in obj)
    if type(obj) is dict:
        return {k: _split(v, arrays) for k, v in obj.items()}
    return obj


def _join(skel, arrays, device):
    if isinstance(skel, _Array):
        a = arrays[skel.index]
        return torch.from_numpy(a).to(device) if skel.tensor else a
    if isinstance(skel, _Record):
        return skel.cls(**{k: _join(v, arrays, device)
                           for k, v in skel.fields.items()})
    if type(skel) in (list, tuple):
        return type(skel)(_join(s, arrays, device) for s in skel)
    if type(skel) is dict:
        return {k: _join(v, arrays, device) for k, v in skel.items()}
    return skel


def cached(g, kind: str, builder: Callable[[], T], cache_dir: str = None,
           enable: bool = True, params: str = "") -> T:
    """Build or load the view ``kind`` of graph ``g``.

    ``params`` must name every builder argument that changes the view (tile
    sizes, bucket widths, ``row_pad``, ...): it is part of the key, so
    another parameterisation never returns the first one's layout.
    """
    if not enable:
        return builder()
    base = cache_dir or _default_dir()
    os.makedirs(base, mode=0o700, exist_ok=True)
    # The prefix keeps the JAX package's entries (a shared COB_CACHE_DIR)
    # apart: their pickles hold JAX objects.
    path = os.path.join(base,
                        f"torch-{kind}-{graph_key(g, kind + ':' + params)}")
    arrays_f, tree_f = path + ".npz", path + ".tree"
    if (os.path.exists(arrays_f) and os.path.exists(tree_f)
            and _dir_is_trusted(base)):
        try:
            with open(tree_f, "rb") as f:
                skel = pickle.load(f)
            with np.load(arrays_f) as data:
                arrays = [data[f"a{i}"] for i in range(len(data.files))]
            return _join(skel, arrays, g.device)
        except _LOAD_ERRORS:
            pass                        # damaged or foreign entry: rebuild
    view = builder()
    arrays: List[np.ndarray] = []
    skel = _split(view, arrays)
    tmp = f"{path}.tmp{os.getpid()}"
    np.savez(tmp + ".npz", **{f"a{i}": a for i, a in enumerate(arrays)})
    with open(tmp + ".tree", "wb") as f:
        pickle.dump(skel, f)
    os.replace(tmp + ".npz", arrays_f)
    os.replace(tmp + ".tree", tree_f)
    return view
