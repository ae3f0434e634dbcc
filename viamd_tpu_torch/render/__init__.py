"""Molecule rendering: camera, colouring, the impostor ray cast (with its
CUDA kernel, csrc/raster.cu) and the postprocess chain (HBAO, tonemaps,
FXAA 3.11). Counterpart of viamd_tpu/render/."""
