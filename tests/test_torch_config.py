"""Port parity: cubemapslam_tpu_torch.config against cubemapslam_tpu.config."""

import dataclasses

import pytest

from cubemapslam_tpu import config as JC
from cubemapslam_tpu_torch import config as TC

DERIVED = ("cube_w", "cube_h", "face_fx", "face_fy", "face_cx", "face_cy",
           "cos_fov_th", "scale_factors", "level_sigma2")

OVERRIDES = [
    {},
    dict(cube_face_w=128, cube_face_h=128, n_features=256, n_levels=4,
         max_keyframes=16, max_landmarks=2048),
    dict(cube_face_w=160, cube_face_h=160, scale_factor=1.3, fov_deg=180.0),
]


@pytest.mark.parametrize("kw", OVERRIDES)
def test_fields_and_derived_equal(kw):
    j, t = JC.SlamConfig(**kw), TC.SlamConfig(**kw)
    jf = [f.name for f in dataclasses.fields(j)]
    assert jf == [f.name for f in dataclasses.fields(t)]
    for name in jf:
        assert getattr(j, name) == getattr(t, name), name
    for name in DERIVED:
        assert getattr(j, name) == getattr(t, name), name


def test_yaml_loading_equal(tmp_path):
    text = """%YAML:1.0
# comment
Camera.Iw: 754
Camera.Ih: 480
Camera.nrpol: 5
Camera.a0: -209.2
Camera.a2: 0.0021
Camera.nrinvpol: 3
Camera.pol0: 293.6
Camera.pol1: 149.9
Camera.pol2: -10.4
Camera.c: 0.9996
Camera.u0: 392.2
Camera.v0: 243.4
CubeFace.w: 320
CubeFace.h: 320
Camera.withFisheyeMask: 1
ORBextractor.nFeatures: 1500
Viewer.PointSize:2
Viewer.Name: "view"
"""
    p = tmp_path / "cam.yaml"
    p.write_text(text)
    assert JC.parse_opencv_yaml(str(p)) == TC.parse_opencv_yaml(str(p))
    j = JC.load_config(str(p), n_levels=6)
    t = TC.load_config(str(p), n_levels=6)
    for f in dataclasses.fields(j):
        assert getattr(j, f.name) == getattr(t, f.name), f.name
