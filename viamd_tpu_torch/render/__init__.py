"""Molecule and volume rendering: camera, colouring, the impostor ray cast
(with its CUDA kernel, csrc/raster.cu), the volume ray-march (with its CUDA
kernel, csrc/volume.cu) and the postprocess chain (HBAO, motion blur, bokeh
DOF, tonemaps, FXAA 3.11, sharpen, TAA). Counterpart of viamd_tpu/render/."""
