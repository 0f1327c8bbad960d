"""The benchmark's plain reference: NumPy code, written or frozen here,
that computes from the same decoded frames the bytes timg writes for a
payload.  It imports nothing of the program (timg_tpu_torch), nothing of
the JAX package (timg_tpu) and no jax.

- ``precision``: the float precision every float stage computes in;
  ``F32`` is what the program states, ``BF16`` is the control;
- ``stb_taps``: stb_image_resize2's taps (a frozen copy);
- ``pixels``: the stb resize and the alpha compose;
- ``cells``: the quarter block cells;
- ``encode``: the ANSI escape bytes;
- ``streams``: what one payload of the library cell has to be.
"""
