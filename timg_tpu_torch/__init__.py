"""timg-tpu-torch: the PyTorch/CUDA port of timg_tpu for NVIDIA Hopper.

The JAX package (``timg_tpu``) is the reference; this package runs the
same pipeline in PyTorch with hand-written CUDA kernels on an H100
(sm_90a) and must produce the same bytes.  Every module mirrors the path
of its counterpart, so ``timg_tpu/X.py`` is ported as
``timg_tpu_torch/X.py``.  This package imports neither jax nor anything
of ``timg_tpu``: the jax-free modules it needs (options, geometry,
terminal queries, the canvas/sequencer/renderer, the numpy mirrors, the
libsixel palette, the native C helper) are its own copies, with only
their imports rewritten.  tests/test_torch_isolation.py holds it to that.

Slices ported so far: the sustained sixel video loop on 4:2:0 video,
``-p sixel`` with every ``--dither`` mode (cube, libsixel, adaptive,
auto); the library API's sixel model (``models.get("sixel")``).

Layer map (entry point down to the device):

  cli.py                 -- flag surface & session orchestration
                            (twin of timg_tpu/cli.py, sixel video only)
  models/                -- library API: SixelModel (render_batch,
                            render_batch_yuv)
  sources/base.py        -- source factory (video only so far)
  sources/video_source.py-- libav decode -> 8-frame YUV windows
  render/plane_cache.py  -- per-window device flow: convert -> resize ->
                            dither (cube | libsixel | adaptive) -> fetch;
                            DeviceFrame placeholders, PlaneCache
  render/sixel_render.py -- SixelCanvas; C sixel assembly (native/) or
                            its Python twin
  render/{canvas,sequencer,renderer}.py -- pacing and cursor control
  ops/sixel_runs.py      -- device->host plane transport + STATS
  ops/yuv.py             -- BT.601 4:2:0 -> RGBA words (torch integer ops)
  ops/pipeline.py        -- resize_compose (library API)
  ops/resize.py          -- video tap tables + plain torch resize;
                            stb-exact RGBA resize (torch ops)
  ops/compose.py         -- alpha compose against the background
  ops/resize_kernel.py   -- CUDA resize kernels (csrc/resize_words.cu;
                            csrc/resize_passes.cu where no tile fits)
  ops/sixel.py           -- cube constants; 3-channel dither entry points
  ops/sixel_kernel.py    -- CUDA FS wavefront driver (csrc/fs_dither_cube.cu)
                            and its band plan; f32 carries, cube and
                            median-cut tree, on words or bytes
  ops/libsixel_kernel.py -- CUDA bucket tables (csrc/bucket_tables.cu) and
                            libsixel integer FS (the same driver)
  ops/{sixel_np,libsixel_quant,resize_np,_resize_weights}.py
                         -- host numpy: median-cut tree, libsixel palette,
                            stb taps and pass order
  ops/_build.py          -- nvcc build of csrc/ into one ctypes library
  ops/backend.py         -- the process's torch.device
  native/runtime.py      -- g++ build of native/*.cc: C sixel assembler,
                            libav video decoder (where libav exists)
"""

__version__ = "0.1.0"
