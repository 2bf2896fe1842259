"""The reference library's example programs on the port.

Counterparts: ``examples/{compress,decompress}_{gray,color}.py`` at the
repository root (the JAX package's), which mirror the reference C
library's ``example/src`` programs.  Each module is run as

    python -m icer_compression_tpu_torch.examples.<name> [in] [out]
        [--device cuda|cpu]

with the JAX examples' configurations: grayscale stages 4, filter A, 6
segments at a 30,000-byte quota; colour (RGB -> YCbCr through
``utils/colorspace``) stages 4, filter A, 10 segments at 100,000 bytes.
Images are read and written with ``utils/image_io`` (8-bit PNG without
Pillow) and encoded at their own size: the JAX examples' resize to
512x512 leaves boat as it is.  The entry points run on the card unless
``--device cpu`` is given.
"""
