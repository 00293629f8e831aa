"""Fangshan / vehicle sequence runner (Examples/cubemap_fangshan.cpp
analog): plain-filename image lists with name-parsed timestamps
(cubemap_fangshan.cpp:90-102)."""

from cubemapslam_tpu_torch.apps.run_sequence import main

if __name__ == "__main__":
    raise SystemExit(main())
