"""Scalar NumPy oracle — the executable specification of every codec
stage: the port's copy of alacjax/oracle/, so the port imports nothing
of the JAX package.  The codec's decode sends the lanes its device
program still flags to ``ALACDecoder``; the differential campaign
(tools/torch_fuzz_soak.py, chip_smoke.py phase 13) holds the codec to it
and builds its legal packets with its header writers and ``matrix``.

Written straight from SURVEY.md §2 (reference: codec/matrix_{enc,dec}.c,
dp_{enc,dec}.c, ag_{enc,dec}.c, ALACEncoder.cpp, ALACDecoder.cpp).  This
package is deliberately naive and sequential: it defines the exact integer
semantics the device path must reproduce bit-for-bit.  Details marked
"VERIFY vs reference" define this repository's ALAC dialect; lossless
round-trip is the correctness gate.
"""

from .matrix import mix, unmix, shift_off, shift_in
from .dp import init_coefs, pc_block, unpc_block
from .ag import AGParams, dyn_comp, dyn_decomp, set_standard_ag_params
from .encoder import ALACEncoder
from .decoder import ALACDecoder

__all__ = [
    "mix", "unmix", "shift_off", "shift_in",
    "init_coefs", "pc_block", "unpc_block",
    "AGParams", "dyn_comp", "dyn_decomp", "set_standard_ag_params",
    "ALACEncoder", "ALACDecoder",
]
