"""What a traffic kind hands the harness."""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class Traffic(NamedTuple):
    """Frames as a camera delivers them, and their true poses.

    ``frames`` (n, H, W) uint8 on the host; ``poses`` the n world->camera
    (R, t) the frames were rendered at. Set-up feeds ``slam`` in SLAM mode,
    switches to the configuration's mode, then feeds ``warmup``; the
    window feeds ``window`` in order, from its start again at its end."""

    frames: torch.Tensor
    poses: List[Tuple[np.ndarray, np.ndarray]]
    slam: List[int]
    warmup: List[int]
    window: Sequence[int]

    def window_frame(self, i: int) -> int:
        """The frame fed as the window's i-th."""
        return self.window[i % len(self.window)]
