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

Slices ported so far: stills and animations from every decoder of the
JAX package (QOI, what Pillow decodes, Radiance HDR, SVG, PDF,
PostScript, OpenSlide, DPX, Cineon, XWD, MIFF, RLA, XCF and text), with
the grid contact sheet, auto-crop, ``-a`` and scroll; and video of
every pixel format (4:2:0 as planes, the rest and transparent-capable
files as RGBA frames, APNG and GIF included), with ``--resample=sws``
and ``--resample=sws-bitexact`` too; in ``-p sixel`` with every
``--dither`` mode (cube, libsixel, adaptive, auto), in ``-p quarter``
/ ``-p half`` and in ``-p kitty`` / ``-p iterm2``; the library API's
sixel, block, kitty and iterm2 models (``models.get(...)``).  Decode
and the PNG encode run on the host, everything between them on the
device, small stills included.

Layer map (entry point down to the device):

  timg-tpu-torch-fast    -- C launcher (native/timg_fast_main.cc): with
                            the CPU asked, renders stills on the host;
                            else its client hands the invocation to the
                            server, or it execs timg-tpu-torch
  timg-tpu-torch         -- launcher: with the CPU asked, the host fast
                            path (fast.py -> native/timg_still.cc, no
                            numpy or torch) first; then a resident
                            server when one listens (serve.try_serve,
                            before torch loads); else cli.main, in the
                            interpreter re-executed with site
  serve.py               -- --serve: the resident session on the port's
                            own unix socket (timg_tpu/serve.py's protocol)
  version.py             -- --version rows (no compiler started)
  cli.py                 -- flag surface & session orchestration
                            (twin of timg_tpu/cli.py; the grid collector)
  parallel/auto.py       -- --devices: shards of a window over cards
                            (shard_batch_call), a large still's rows over
                            them (spatial_shard_call)
  parallel/mesh.py       -- (data, space) grids and the sharded quarter
                            and video sixel pipelines
  models/                -- library API: SixelModel (render_batch,
                            render_batch_yuv), the block models, the
                            kitty and iTerm2 models
  sources/base.py        -- source factory, in the JAX package's order:
                            OpenSlide, QOI, HDR, SVG, PDF, PostScript,
                            GM formats, Pillow, video, text
  sources/{hdr_source,svg_source,pdf_source,ps_source,openslide_source,
          gm_formats,xcf,text_source}.py -- the other decoders (host),
                            then pil_source's path
  sources/pil_source.py  -- Pillow decode (JPEG draft, EXIF, ICO, GIF
                            salvage) -> resize + compose on the device
                            -> the RGBA windows' planes
  sources/qoi_source.py  -- QOI decode (numpy), then pil_source's path
  sources/batch.py       -- grid contact sheet: one resize a geometry
  sources/scroll.py      -- scroll windows as rolls on the device
  sources/video_source.py-- libav decode -> 8-frame windows: YUV planes,
                            RGBA frames (K1 resize, or the stb resize
                            and the lazy compose), or host-swscaled
                            frames (--resample=sws)
  render/plane_cache.py  -- per-window device flow: convert -> resize
                            (or the sws kernel) -> dither (cube |
                            libsixel | adaptive) -> fetch, the block
                            cells, or the pixel window's words fetched
                            frame by frame in the encode pool; the RGBA
                            windows of
                            stills, animations and scroll;
                            DeviceFrame placeholders, PlaneCache
  render/sixel_render.py -- SixelCanvas; C sixel assembly (native/) or
                            its Python twin, from planes or run records;
                            the DCS bands' splice
  render/{kitty,iterm2}.py -- kitty and iTerm2 canvases (PNG in the
                            compression pool; kitty's ids and tmux)
  render/{png,png_core}.py -- PNG writer: native Sub filter, libdeflate
                            or zlib
  render/{canvas,sequencer,renderer}.py -- pacing and cursor control
  ops/sixel_runs.py      -- device->host transport (plane, run records or
                            DCS bands; TIMG_TPU_SIXEL_TRANSPORT) + STATS;
                            CUDA run kernels (ops/sixel_runs_kernel.py,
                            csrc/sixel_runs.cu)
  ops/sixel_dcs.py       -- device-emitted DCS bodies and splice_host;
                            CUDA kernels (ops/sixel_dcs_kernel.py,
                            csrc/sixel_dcs.cu)
  ops/yuv.py             -- BT.601 4:2:0 -> RGBA words (torch integer ops)
  ops/sws_resize.py      -- --resample=sws-bitexact: swscale's plan, the
                            kernel's tiling and the plain version; CUDA
                            kernel (ops/sws_kernel.py, csrc/sws_yuv420.cu);
                            ops/sws_model.py, the scalar oracle (copy)
  ops/pipeline.py        -- resize_compose (library API)
  ops/resize.py          -- video tap tables + plain torch resize;
                            stb-exact RGBA resize, nearest (torch ops)
  ops/compose.py         -- alpha compose against the background
  ops/exact.py           -- the exact floor root of compose and blocks
  ops/autocrop.py        -- auto-crop bounds (torch reductions)
  ops/blocks.py          -- block cells (CUDA csrc/block_cells.cu)
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
                            C ANSI emitter, libsixel's quantizer and
                            palette; libav video decoder (where libav
                            exists)
"""

__version__ = "0.1.0"
