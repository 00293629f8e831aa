"""Command-line runners of the port, counterparts of
``cubemapslam_tpu/apps/`` (the reference's Examples/cubemap_lafida.cpp and
Examples/cubemap_fangshan.cpp)."""
