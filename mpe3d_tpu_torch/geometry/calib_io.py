"""Calibration files: pytransform3d pickles and the JSON transform format.

Port of ``mpe3d_tpu/geometry/calib_io.py``.  The reference stores rig
extrinsics as pickled ``pytransform3d`` ``TransformManager`` objects
(``tm_panoptic.pickle`` / ``tm_arp.pickle``).  They load here without
pytransform3d: a stub unpickler materialises the stored ``transforms``
dict ({(from_frame, to_frame): 4x4}) and ``TransformSet`` answers direct,
inverse and multi-hop queries itself.  A JSON format is also provided.

The JAX package's conversor pickles its own ``TransformSet``
(``mpe3d_tpu.geometry.calib_io.TransformSet``); such a file loads here as
the port's class, without importing the JAX package, and
``write_transform_set_pickle`` writes the port's under that name, so a
``tm_<seq>.pickle`` of either package loads in both.

Unpickling can run code named in the file: load only calibration files
from a source you trust, as with pytransform3d itself.
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

from mpe3d_tpu_torch.config import RigConfig
from mpe3d_tpu_torch.geometry.camera import (CameraRig,
                                             intrinsics_from_rig_config,
                                             make_rig)


class _Stub:
    """Placeholder for pytransform3d classes inside pickles."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


# the class the JAX package's pickles name for a TransformSet
_JAX_TRANSFORM_SET = ("mpe3d_tpu.geometry.calib_io", "TransformSet")


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("pytransform3d"):
            return type(name, (_Stub,), {"__module__": module})
        if (module, name) == _JAX_TRANSFORM_SET:
            return TransformSet
        return super().find_class(module, name)


class TransformSet:
    """Minimal transform graph: stores (from, to) -> 4x4 and answers
    ``get_transform`` queries like pytransform3d."""

    def __init__(self, transforms: Dict[Tuple[str, str], np.ndarray]):
        self.transforms = {k: np.asarray(v, np.float64)
                           for k, v in transforms.items()}

    def get_transform(self, from_frame: str, to_frame: str,
                      _visited: Optional[frozenset] = None) -> np.ndarray:
        if (from_frame, to_frame) in self.transforms:
            return self.transforms[(from_frame, to_frame)]
        if (to_frame, from_frame) in self.transforms:
            return np.linalg.inv(self.transforms[(to_frame, from_frame)])
        # multi-hop composition through shared frames; the visited set
        # bounds the recursion on cyclic graphs and unreachable frames
        visited = (_visited or frozenset()) | {from_frame}
        for (a, b), T_ab in self.transforms.items():
            if a == from_frame and b not in visited:
                try:
                    return self.get_transform(b, to_frame, visited) @ T_ab
                except KeyError:
                    continue
            if b == from_frame and a not in visited:
                try:
                    return (self.get_transform(a, to_frame, visited)
                            @ np.linalg.inv(T_ab))
                except KeyError:
                    continue
        raise KeyError(f"No transform {from_frame} -> {to_frame}")

    def to_json(self) -> str:
        # a list of [from, to, T]: frame names may contain spaces
        return json.dumps({"transforms": [[a, b, T.tolist()]
                           for (a, b), T in self.transforms.items()]})

    @classmethod
    def from_json(cls, text: str) -> "TransformSet":
        raw = json.loads(text)
        if isinstance(raw, dict) and "transforms" in raw:
            return cls({(a, b): np.array(T)
                        for a, b, T in raw["transforms"]})
        # legacy format {"a b": T}: only for names without spaces
        return cls({tuple(k.split(" ")): np.array(v)
                    for k, v in raw.items()})


class _JaxNamePickler(pickle._Pickler):
    """The pure-Python pickler with the port's ``TransformSet`` class
    written as the JAX package's (``_JAX_TRANSFORM_SET``): the rest of the
    stream is what ``pickle.dump`` writes, so the bytes equal the JAX
    conversor's for the same transforms."""

    def save_global(self, obj, name=None):
        if obj is not TransformSet:
            return super().save_global(obj, name)
        for part in _JAX_TRANSFORM_SET:
            self.save(part)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def write_transform_set_pickle(ts: TransformSet, f) -> None:
    """Pickle ``ts`` into the binary file ``f`` as the JAX conversor does
    (``pickle.dump`` of its TransformSet, the default protocol, 4 or
    more, which ``STACK_GLOBAL`` needs).  The class name is rewritten in
    ``save_global``, a method that only the pure-Python pickler
    (``pickle._Pickler``) calls: the C ``pickle.Pickler`` does not."""
    _JaxNamePickler(f, pickle.DEFAULT_PROTOCOL).dump(ts)


def load_transform_manager(path: str) -> TransformSet:
    """A pytransform3d TransformManager pickle, or the JSON format (a
    ``.json`` path), as a TransformSet."""
    if str(path).endswith(".json"):
        with open(path) as f:
            return TransformSet.from_json(f.read())
    with open(path, "rb") as f:
        tm = _StubUnpickler(f).load()
    transforms = getattr(tm, "transforms", None)
    if transforms is None:
        raise ValueError(f"{path} does not look like a TransformManager "
                         f"pickle")
    return TransformSet(dict(transforms))


def rig_from_files(rig_config: RigConfig, tm_path: str) -> CameraRig:
    """The rig's CameraRig from its RigConfig and a calibration file: the
    world -> camera transform of each camera is ``get_transform('root',
    cam)``, as the reference loads it (skeleton_matching/
    graph_generator.py:39-52)."""
    ts = load_transform_manager(tm_path)
    T_wc = np.stack([ts.get_transform("root", cam)
                     for cam in rig_config.camera_names])
    K, dist = intrinsics_from_rig_config(rig_config)
    return make_rig(K, dist, T_wc,
                    (rig_config.image_width, rig_config.image_height))
