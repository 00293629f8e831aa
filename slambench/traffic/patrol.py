"""A patrol of a mapped route: laps of a closed circuit (radius
``radius`` about a fixed centre, the optical axis along the direction of
travel, ``step`` map units a frame) through ``billboards`` billboards
anchored along lap 0, each lap on its own line. Lap 0 is on the circle
itself; the later laps are offset sideways, the offsets spread evenly over
+-``lateral_offset`` and dealt to the laps by the run's seed, so that every
seed drives the same lines in another order. Set-up maps lap 0; the
warm-up and the window follow laps 1, 2, ..., 0, 1, ... in turn, cycling.

The world is drawn from ``world_seed``, not the run's seed, so that every
run patrols the same site and its map: the world's generator first draws
``laps - 1`` numbers that it does not use, the draws under which this
world's lap-0 map was found to hold on the card."""

from __future__ import annotations

import math

import numpy as np

from slambench.traffic import world as Wd
from slambench.traffic.common import Traffic


def lap(n: int, radius: float, offset: float):
    """One lap of n frames, world->camera (R, t), at ``radius + offset``
    about the centre (0, 0, radius)."""
    poses = []
    r = radius + offset
    for k in range(n):
        phi = 2.0 * np.pi * k / n
        t_wc = np.array([r * np.sin(phi), 0.0, radius - r * np.cos(phi)],
                        np.float32)
        R = Wd._yaw(phi - 0.5 * np.pi)
        poses.append((R, -R @ t_wc))
    return poses


def make(params: dict, seed: int, seconds: float, cam, device) -> Traffic:
    radius = params["radius"]
    n_lap = int(round(2.0 * math.pi * radius / params["step"]))
    n_off = params["laps"] - 1
    offs = [0.0] + list(np.random.default_rng(seed).permutation(
        np.linspace(-1.0, 1.0, n_off)) * params["lateral_offset"])
    laps = [lap(n_lap, radius, o) for o in offs]
    wrng = np.random.default_rng(params["world_seed"])
    wrng.uniform(-1.0, 1.0, n_off)
    world = Wd.make_world(wrng, n=params["billboards"],
                          centers=Wd.camera_centres(laps[0]), fx=cam.focal)
    poses = [p for one in laps for p in one]
    frames = Wd.render_frames(cam, world, poses, device)
    # after lap 0: laps 1, 2, ..., then lap 0 again
    order = list(range(n_lap, len(poses))) + list(range(n_lap))
    warm = int(params["warmup_frames"])
    return Traffic(frames=frames, poses=poses, slam=list(range(n_lap)),
                   warmup=order[:warm],
                   window=order[warm:] + order[:warm])
