"""Map save and load (checkpoint and resume).

Counterpart of ``cubemapslam_tpu/serialize.py``: the arena, the vocabulary,
the BoW table and the counters of a ``CubemapSLAM`` in one npz, in the JAX
package's format and dtypes (uint32 descriptor words, int32 index tables),
so that a map saved by either package loads in the other. A loaded system
starts LOST and picks the map up by relocalization.
"""

from __future__ import annotations

import numpy as np
import torch

from cubemapslam_tpu_torch import interop

_FORMAT_VERSION = 1


def save_map(system, path: str) -> None:
    """Write ``system``'s arena, vocabulary, BoW table and counters to one
    npz (``serialize.py:22-38``)."""
    data = {f"arena_{k}": v
            for k, v in interop.arena_to_numpy(system.arena).items()}
    data["n_kf"] = np.int64(system.n_kf)
    data["frame_id"] = np.int64(system.frame_id)
    data["format_version"] = np.int64(_FORMAT_VERSION)
    if system.vocab is not None:
        v = interop.vocab_to_numpy(system.vocab)
        for i, c in enumerate(v["centers"]):
            data[f"vocab_centers_{i}"] = c
        data["vocab_idf"] = v["idf"]
        data["vocab_k"] = np.int64(v["k"])
        data["vocab_depth"] = np.int64(v["depth"])
    if system.bow_table is not None:
        data["bow_table"] = system.bow_table.cpu().numpy()
    np.savez_compressed(path, **data)


def load_map(system, path: str) -> None:
    """Restore a saved map into ``system`` on its device; it is left LOST,
    to relocalize against the map (``serialize.py:41-63``)."""
    from cubemapslam_tpu_torch.runtime.system import TrackState

    dev = system.device
    with np.load(path) as z:
        if int(z["format_version"]) != _FORMAT_VERSION:
            raise ValueError(f"{path}: map format {int(z['format_version'])}"
                             f", expected {_FORMAT_VERSION}")
        system.arena = interop.arena_from_numpy(
            {k[len("arena_"):]: z[k] for k in z.files
             if k.startswith("arena_")}, dev)
        system.n_kf = int(z["n_kf"])
        system.frame_id = int(z["frame_id"])
        if "vocab_idf" in z.files:
            depth = int(z["vocab_depth"])
            system.vocab = interop.vocab_from_numpy(dict(
                centers=[z[f"vocab_centers_{i}"] for i in range(depth)],
                idf=z["vocab_idf"], k=int(z["vocab_k"]), depth=depth), dev)
        if "bow_table" in z.files:
            system.bow_table = torch.as_tensor(z["bow_table"], device=dev)
    system.state = TrackState.LOST
    system.velocity = None
    system.covis = system.cnt = None
    system.drop_graphs()
