"""Version reporting (counterpart of timg_tpu/version.py; ref
src/timg-print-version.cc).

The rows are the JAX package's, in its order, with its jax row
replaced by torch, CUDA and the card(s), and one row more: the state of
the CUDA kernel library.  Nothing here starts a compiler: the native
helper and the kernel library are described as built, never built.
"""

from __future__ import annotations

import os
import sys


def _framework_row() -> str:
    import torch

    if not torch.cuda.is_available():
        return f"torch {torch.__version__}; CUDA not available"
    n = torch.cuda.device_count()
    return (f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
            f"device: {torch.cuda.get_device_name(0)} ({n} device(s))")


def _kernels_row() -> str:
    from timg_tpu_torch.ops import _build

    lib = "timg_tpu_torch/csrc/build/libtimg_torch_kernels.so"
    if not os.path.exists(_build.LIB_PATH):
        return f"CUDA kernels: {lib} missing (built at first use)"
    if _build._stale():
        return f"CUDA kernels: {lib} stale (rebuilt at first use)"
    return f"CUDA kernels: {lib} built and fresh"


def print_component_versions() -> int:
    """Print our version plus every dependency's (ref
    timg-print-version.cc:59-128)."""
    from timg_tpu_torch import __version__

    print(f"timg-tpu-torch {__version__} <https://github.com/timg-tpu>")
    print("PyTorch/CUDA port of the TPU-native terminal image & video "
          "viewer.")
    print()
    try:
        print(_framework_row())
    except Exception as e:  # pragma: no cover
        print(f"torch unavailable: {e}")
    try:
        import numpy
        print(f"numpy {numpy.__version__}")
    except ImportError:
        pass
    try:
        import PIL
        print(f"Pillow {PIL.__version__} (image decode)")
    except ImportError:
        print("Pillow not available")
    try:
        from timg_tpu_torch.native import runtime
        print(f"native runtime: {runtime.describe()}")
    except Exception:
        print("native runtime: not built (python fallbacks active)")
    print(_kernels_row())
    # Optional decoder gates, listed like the reference's per-feature
    # rows (ref timg-print-version.cc:59-128).
    print("QOI image loading")
    try:
        from timg_tpu_torch.sources.svg_source import _load as _svg_load
        print("SVG rendering with librsvg + cairo"
              if _svg_load() is not None else
              "SVG rendering unavailable (librsvg not found)")
    except Exception:  # pragma: no cover
        pass
    try:
        from timg_tpu_torch.sources.pdf_source import poppler_available
        print("PDF rendering with poppler-glib + cairo"
              if poppler_available() else
              "PDF rendering unavailable (poppler-glib not found)")
    except Exception:  # pragma: no cover
        pass
    try:
        from timg_tpu_torch.sources.openslide_source import _lib as _slide_lib
        print("OpenSlide scientific-image loading"
              if _slide_lib() is not None else
              "OpenSlide unavailable (libopenslide not found)")
    except Exception:  # pragma: no cover
        pass
    print(f"python {sys.version.split()[0]}")
    print("Half, quarter, sixel, iterm2, and kitty graphics output: builtin.")
    return 0
