"""timg-tpu-torch: the PyTorch/CUDA port of timg_tpu for NVIDIA Hopper.

The JAX package (``timg_tpu``) is the reference; this package runs the
same pipeline in PyTorch with hand-written CUDA kernels on an H100
(sm_90a) and must produce the same bytes.  Every module mirrors the path
of its counterpart, so ``timg_tpu/X.py`` is ported as
``timg_tpu_torch/X.py``.  Modules of ``timg_tpu`` that import no jax
(decoders' native helper, options, geometry, terminal queries, the
canvas/sequencer/renderer, the numpy mirrors, the C sixel assembler)
are reused as they are.  This package never imports jax.

Slices ported so far: the sustained sixel video loop on 4:2:0 video,
``-p sixel`` with every ``--dither`` mode (cube, libsixel, adaptive,
auto).

Layer map (entry point down to the device):

  cli.py                 -- flag surface & session orchestration
                            (twin of timg_tpu/cli.py, sixel video only)
  sources/base.py        -- source factory (video only so far)
  sources/video_source.py-- libav decode -> 8-frame YUV windows
  render/plane_cache.py  -- per-window device flow: convert -> resize ->
                            dither (cube | libsixel | adaptive) -> fetch;
                            DeviceFrame placeholders
  render/sixel_render.py -- SixelCanvas popping the port's plane cache;
                            C sixel assembly (timg_tpu native helper)
  ops/sixel_runs.py      -- device->host plane transport + STATS
  ops/yuv.py             -- BT.601 4:2:0 -> RGBA words (torch integer ops)
  ops/resize.py          -- tap tables + plain torch resize; dispatch
  ops/resize_kernel.py   -- CUDA resize kernel (csrc/resize_words.cu)
  ops/sixel.py           -- cube palette constants
  ops/sixel_kernel.py    -- CUDA FS dither with f32 carries, cube and
                            median-cut tree (csrc/fs_dither_cube.cu)
  ops/libsixel_kernel.py -- CUDA bucket tables and libsixel integer FS
                            (csrc/bucket_tables.cu, csrc/fs_dither_table.cu)
  ops/_build.py          -- nvcc build of csrc/ into one ctypes library
  ops/backend.py         -- the process's torch.device
"""

__version__ = "0.1.0"
