"""MSB-first bit-serial reader/writer over a byte buffer: the port's copy
of alacjax/bitbuffer.py (what the port's oracle and chip_smoke.py use).

Host-side rebuild of the reference's ``codec/ALACBitUtilities.{h,c}``
``BitBuffer``.  The device path (alacjax_torch.ops.bitpack) assembles
bitstreams via prefix-sum + word scatter instead; this class is the
oracle's cursor, and defines the wire bit order: the first bit written
is the MSB of byte 0.
"""

from __future__ import annotations

from .types import AlacParamError


class BitBuffer:
    """Mutable bit cursor over a bytearray.

    Mirrors BitBufferInit/Read/ReadSmall/ReadOne/Write/Advance/Rewind/
    ByteAlign/GetPosition/Reset from the reference, as methods.
    """

    __slots__ = ("buf", "bitpos", "byte_size")

    def __init__(self, data: bytes | bytearray | None = None, byte_size: int | None = None):
        if data is None:
            if byte_size is None:
                raise AlacParamError("BitBuffer needs data or byte_size")
            self.buf = bytearray(byte_size)
        else:
            self.buf = bytearray(data)
        self.byte_size = len(self.buf)
        self.bitpos = 0

    # -- position ----------------------------------------------------------
    def get_position(self) -> int:
        """Current absolute bit position (BitBufferGetPosition)."""
        return self.bitpos

    def set_position(self, bitpos: int) -> None:
        self.bitpos = bitpos

    def advance(self, num_bits: int) -> None:
        """BitBufferAdvance."""
        self.bitpos += num_bits

    def rewind(self, num_bits: int) -> None:
        """BitBufferRewind."""
        self.bitpos -= num_bits

    def reset(self) -> None:
        self.bitpos = 0

    def byte_align(self, add_zeros: bool) -> None:
        """BitBufferByteAlign: pad cursor to the next byte boundary.

        On the write path (``add_zeros=True``) the skipped bits are written
        as zeros; on the read path the cursor simply advances.
        """
        rem = self.bitpos & 7
        if rem == 0:
            return
        if add_zeros:
            self.write(0, 8 - rem)
        else:
            self.advance(8 - rem)

    def bytes_used(self) -> int:
        return (self.bitpos + 7) >> 3

    # -- read --------------------------------------------------------------
    def read(self, num_bits: int) -> int:
        """Read up to 32 bits MSB-first (BitBufferRead / ReadSmall / ReadOne).

        The reference splits this into ≤16/≤8/1-bit variants purely for C
        speed; semantics are identical.
        """
        if num_bits == 0:
            return 0
        if not (0 < num_bits <= 32):
            raise AlacParamError(f"read of {num_bits} bits")
        end_bit = self.bitpos + num_bits
        if end_bit > self.byte_size * 8:
            raise AlacParamError("BitBuffer read past end")
        result = 0
        pos = self.bitpos
        while pos < end_bit:
            byte = self.buf[pos >> 3]
            bit_in_byte = pos & 7
            take = min(8 - bit_in_byte, end_bit - pos)
            chunk = (byte >> (8 - bit_in_byte - take)) & ((1 << take) - 1)
            result = (result << take) | chunk
            pos += take
        self.bitpos = end_bit
        return result

    def read_small(self, num_bits: int) -> int:
        return self.read(num_bits)

    def read_one(self) -> int:
        return self.read(1)

    def peek(self, num_bits: int) -> int:
        pos = self.bitpos
        val = self.read(num_bits)
        self.bitpos = pos
        return val

    def peek_word(self) -> int:
        """Load 32 bits starting at the cursor, zero-padded past the end —
        the reference decode loops (ag_dec.c :: dyn_get) load a 32-bit window
        like this to scan unary prefixes."""
        byte_idx = self.bitpos >> 3
        window = bytes(self.buf[byte_idx:byte_idx + 5]) + b"\x00" * 5
        word40 = int.from_bytes(window[:5], "big")
        return (word40 >> (8 - (self.bitpos & 7))) & 0xFFFFFFFF

    # -- write -------------------------------------------------------------
    def write(self, value: int, num_bits: int) -> None:
        """Write up to 32 bits MSB-first (BitBufferWrite)."""
        if num_bits == 0:
            return
        if not (0 < num_bits <= 32):
            raise AlacParamError(f"write of {num_bits} bits")
        value &= (1 << num_bits) - 1
        end_bit = self.bitpos + num_bits
        need = (end_bit + 7) >> 3
        if need > len(self.buf):
            self.buf.extend(b"\x00" * (need - len(self.buf)))
            self.byte_size = len(self.buf)
        pos = self.bitpos
        remaining = num_bits
        while remaining > 0:
            bit_in_byte = pos & 7
            take = min(8 - bit_in_byte, remaining)
            shift = remaining - take
            chunk = (value >> shift) & ((1 << take) - 1)
            byte_idx = pos >> 3
            mask = ((1 << take) - 1) << (8 - bit_in_byte - take)
            self.buf[byte_idx] = (self.buf[byte_idx] & ~mask) | (
                chunk << (8 - bit_in_byte - take)
            )
            pos += take
            remaining -= take
        self.bitpos = end_bit

    def to_bytes(self) -> bytes:
        return bytes(self.buf[: self.bytes_used()])
