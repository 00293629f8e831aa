"""Lafida sequence runner (Examples/cubemap_lafida.cpp analog).

Same positional argv contract as ``run_sequence``; the image list uses the
Lafida "id timestamp filename" format (cubemap_lafida.cpp:91-107).
"""

from cubemapslam_tpu_torch.apps.run_sequence import main

if __name__ == "__main__":
    raise SystemExit(main())
