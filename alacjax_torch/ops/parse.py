"""The decode's element parse in plain torch: the reference that
csrc/parse.cu is held to, and the CPU path of ``kernels.parse.parse_element``.

One element's 23-bit header, its partial frame's 32-bit numSamples, a
CPE's mix token and each channel's param header and coefficients, read
at the element's per-lane start from the (B, W) word image
(alacjax/codec.py :: decode_frames_device's per-element parse).  The
fields come back as a ``Parsed`` in the layout the decode's kernels
read: int32 per-lane rows, a channel's decode-kernel arguments among
them, and the element's escape flags.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..oracle.encoder import bytes_shifted_for_depth
from ..types import AlacConfig, ElementTag, kALACMaxCoefs
from . import bitpack, fused_decode
from .tutils import I32, I64, MASK32, iota1, sign_extend, u32

# rows of Parsed.lanes: the element's, then CHANNEL_ROWS a channel
NUM, POS_ESC, POS_SHIFT, RICE, MIXBITS, MIXRES = range(6)
ELEMENT_ROWS = 6
PB, MODE, ORDER, DEN = range(4)
CHANNEL_ROWS = 4


def lane_rows(width: int) -> int:
    """The rows of an element of ``width`` channels' Parsed.lanes."""
    return ELEMENT_ROWS + CHANNEL_ROWS * width


class Parsed(NamedTuple):
    """One element's parse.  ``readout`` (4,) int32, the decode's one
    readback of the element: its ``flags``, a lane that does not escape
    and a lane that escapes (1 or 0), then its counts, the lanes that
    escape and the lanes whose header carries the sample count (the
    partial-frame field).  ``bits`` (2, B) bool: each lane's escape flag
    and its error.
    ``lanes`` (lane_rows(width), B) int32: rows NUM (the packet's frame
    length), POS_ESC (the bit of an escape lane's verbatim samples),
    POS_SHIFT (the shift-byte block), RICE (the first channel's Rice
    start), MIXBITS and MIXRES (a CPE's, 0 on escape lanes and in an
    SCE), then for channel ci at ELEMENT_ROWS + CHANNEL_ROWS * ci: PB
    (config.pb * pbf // 4), MODE, ORDER (0 on escape lanes, so they
    cannot flag the walk's tap bound) and DEN.
    ``coefs`` (width, B, max_ord) int32: each channel's sign-extended
    coefficients."""
    readout: torch.Tensor
    bits: torch.Tensor
    lanes: torch.Tensor
    coefs: torch.Tensor

    @property
    def width(self) -> int:
        return self.coefs.shape[0]

    flags = property(lambda self: self.readout[:2])
    esc = property(lambda self: self.bits[0])
    err = property(lambda self: self.bits[1])
    num = property(lambda self: self.lanes[NUM])
    pos_esc = property(lambda self: self.lanes[POS_ESC])
    pos_shift = property(lambda self: self.lanes[POS_SHIFT])
    rice = property(lambda self: self.lanes[RICE])
    # a CPE's, None for an SCE
    mixbits = property(lambda self: self._cpe(MIXBITS))
    mixres = property(lambda self: self._cpe(MIXRES))

    def _cpe(self, r: int):
        return self.lanes[r] if self.width == 2 else None

    def _chan(self, r: int, ci: int):
        return self.lanes[ELEMENT_ROWS + CHANNEL_ROWS * ci + r]

    def args(self, ci: int):
        """Channel ``ci``'s decode-kernel arguments (pb, coefs, mode,
        order, denshift), int32."""
        return (self._chan(PB, ci), self.coefs[ci], self._chan(MODE, ci),
                self._chan(ORDER, ci), self._chan(DEN, ci))


def _sfield(words, off: int, n: int):
    """(B,) n-bit field at a STATIC bit offset of a u32 (int64) image."""
    i, ph = off >> 5, off & 31
    a = words[:, i]
    if ph + n > 32:
        a = ((a << ph) & MASK32) | (words[:, i + 1] >> (32 - ph))
        return a >> (32 - n)
    return (a >> (32 - ph - n)) & ((1 << n) - 1)


def _parse_ph(ph, max_ord: int = kALACMaxCoefs):
    """Split a 16-bit channel-param header into (mode, den, pbf, order)."""
    mode = (ph >> 12) & 0xF
    den = (ph >> 8) & 0xF
    pbf = (ph >> 5) & 0x7
    order = ph & 0x1F
    perr = ((order > max_ord) & (order != 31)) | (
        (den == 0) & (order != 0) & (order != 31))
    return (mode, den, pbf, order), perr


def _decode_params_static(words, is_cpe: bool, max_ord: int = kALACMaxCoefs):
    """Header/param parse on a bit-0-aligned element view at static
    offsets; channel 1's fields sit at an offset set by order0, read from
    a 16-bit-stride field table.  Returns (params, end bits relative to
    the element start sans the partial numSamples field, err)."""
    c_ph0 = 23 + 16
    deep = c_ph0 + 16 + 16 * ((31 + max_ord if is_cpe else max_ord) + 1)
    need = deep // 32 + 2
    if words.shape[1] < need:
        words = torch.nn.functional.pad(words, (0, need - words.shape[1]))
    ph0 = _sfield(words, c_ph0, 16)
    (mode0, den0, pbf0, order0), perr = _parse_ph(ph0, max_ord)
    coefs0 = sign_extend(torch.stack(
        [_sfield(words, c_ph0 + 16 + 16 * j, 16) for j in range(max_ord)],
        dim=1), 16)
    params = [(mode0, den0, pbf0, order0, coefs0)]
    end = c_ph0 + 16 + 16 * order0
    if is_cpe:
        H = torch.stack([_sfield(words, c_ph0 + 16 + 16 * m, 16)
                         for m in range(31 + 1 + max_ord + 1)], dim=1)
        # orders outside 0..max_ord and 31 read as order 0 (those lanes
        # are flagged by perr), as the reference's select does
        legal = (order0 <= max_ord) | (order0 == 31)
        o_sel = torch.where(legal, order0, 0)
        ph1 = torch.gather(H, 1, o_sel[:, None])[:, 0]
        (mode1, den1, pbf1, order1), perr1 = _parse_ph(ph1, max_ord)
        perr = perr | perr1
        idx = o_sel[:, None] + 1 + iota1(max_ord, device=H.device)[None, :]
        coefs1 = sign_extend(torch.gather(H, 1, idx), 16)
        params.append((mode1, den1, pbf1, order1, coefs1))
        end = end + 16 + 16 * order1
    return params, end, perr


def _parse_element(w, bitpos, num, tag, width: int, config: AlacConfig,
                   S: int, max_ord: int, fast_hdr: bool):
    """Header parse of one element (alacjax.codec.decode_frames_device's
    per-element loop): ``w`` is the (B, W) u32 image, ``bitpos`` the
    per-lane element start, ``num`` the frame length of the packet's
    first element (None for the first).  A single-element packet is read
    at static offsets; otherwise one window aligned to the element
    carries the same static parse.  Returns a dict with ``esc``,
    ``partial`` (the header's partial-frame flag), ``num``, ``err``, the
    per-channel ``params`` (mode, den, pbf, order, coefs), ``pos_esc``
    (the raw block of an escape lane), ``pos_shift`` (the shift-byte
    block), ``rice`` (the first channel's Rice start) and, for a CPE,
    ``mixbits`` and ``mixres``."""
    depth = config.bit_depth
    is_cpe = width == 2
    if fast_hdr:
        hdr = _sfield(w, 0, 23)
        nsf = _sfield(w, 23, 32)
    else:
        hdr = fused_decode._read_bits(w, bitpos, 23)
        nsf = fused_decode._read_bits(w, bitpos + 23, 32)
    rtag = hdr >> 20
    unused = (hdr >> 4) & 0xFFF
    partial = ((hdr >> 3) & 1) == 1
    bs_f = (hdr >> 1) & 3
    esc = (hdr & 1) == 1
    bs = bytes_shifted_for_depth(depth)
    # a mono slot takes an SCE or an LFE tag, as the oracle and the
    # reference decoder do (FFmpeg writes an SCE for 5.1's LFE)
    tag_ok = (((rtag == int(ElementTag.SCE)) | (rtag == int(ElementTag.LFE)))
              if width == 1 else rtag == int(tag))
    err = (~tag_ok | (unused != 0)
           | (~esc & (bs_f != bs)) | (esc & (bs_f != 0)))

    # partial (tail) frames: 32-bit numSamples right after the header;
    # the elements of one packet must agree on it
    bad_num = partial & ((nsf == 0) | (nsf > S))
    num_el = torch.where(partial & ~bad_num, nsf, S)
    err = err | bad_num
    if num is None:
        num = num_el
    else:
        err = err | (num_el != num)
    pos_esc = bitpos + 23 + torch.where(partial, 32, 0)

    if fast_hdr:
        # partial lanes' fields sit exactly one word later
        ncol = 61
        wpad = (w if w.shape[1] >= ncol + 1
                else torch.nn.functional.pad(w, (0, ncol + 1 - w.shape[1])))
        w_hdr = torch.where(partial[:, None], wpad[:, 1:ncol + 1],
                            wpad[:, :ncol])
    else:
        # the element sans the partial field, aligned to bit 0
        deep = 39 + 16 + 16 * ((31 + max_ord if is_cpe else max_ord) + 1)
        w_hdr = u32(bitpack.extract_segment(w, pos_esc - 23, deep // 32 + 2))
    out = dict(esc=esc, partial=partial, num=num, pos_esc=pos_esc)
    if is_cpe:
        mixtok = _sfield(w_hdr, 23, 16)
        out["mixbits"] = torch.where(esc, 0, mixtok >> 8)
        out["mixres"] = torch.where(esc, 0, sign_extend(mixtok & 0xFF, 8))
    params, end_rel, perr = _decode_params_static(w_hdr, is_cpe, max_ord)
    out["params"] = params
    out["err"] = err | (~esc & perr)
    pos_shift = torch.where(esc, pos_esc, pos_esc - 23 + end_rel)
    out["pos_shift"] = pos_shift
    out["rice"] = pos_shift + torch.where(esc, 0, width * 8 * bs * num)
    return out


def _parse(words, bitpos, num, tag, width: int, config: AlacConfig,
           num_samples: int, max_ord: int) -> dict:
    """_parse_element on the int32 image, at bit 0 where ``bitpos`` is
    None; a single-element packet at static offsets, as alacjax reads it."""
    fast_hdr = bitpos is None and len(config.elements) == 1
    start = (torch.zeros((words.shape[0],), dtype=I64, device=words.device)
             if bitpos is None else bitpos.to(I64))
    return _parse_element(u32(words), start,
                          None if num is None else num.to(I64), tag, width,
                          config, num_samples, max_ord, fast_hdr)


def params_cut(words, tag, width: int, config: AlacConfig, num_samples: int,
               max_ord: int):
    """alacjax's "params" cut of the decode: the packet's first element's
    per-channel (mode, den, pbf, order, coefs) as read, and (its lanes'
    Rice start bits, err)."""
    p = _parse(words, None, None, tag, width, config, num_samples, max_ord)
    return p["params"], (p["rice"], p["err"])


def parse_element(words, bitpos, num, tag, width: int, config: AlacConfig,
                  num_samples: int, max_ord: int) -> Parsed:
    """One element's parse as a ``Parsed``.  ``words`` is the (B, W)
    int32 word image; ``bitpos`` the (B,) int32 per-lane element start,
    or None for an element at bit 0 (the packet's first); ``num`` the
    (B,) int32 frame length of the packet's first element, None for the
    first.  ``tag`` is the element's ElementTag (a mono slot takes an SCE
    or an LFE), ``width`` its channels (1 or 2), ``max_ord`` the largest
    predictor order accepted besides 31.  A single-element packet is read
    at static offsets, as alacjax does: the same fields as a read at bit
    0 wherever the image has two words."""
    B = words.shape[0]
    p = _parse(words, bitpos, num, tag, width, config, num_samples, max_ord)
    esc = p["esc"]
    zero = torch.zeros((B,), dtype=I64, device=words.device)
    rows = [p["num"], p["pos_esc"], p["pos_shift"], p["rice"],
            p.get("mixbits", zero), p.get("mixres", zero)]
    for mode, den, pbf, order, _ in p["params"]:
        rows += [(config.pb * pbf) // 4, mode, torch.where(esc, 0, order),
                 den]
    return Parsed(
        readout=torch.stack([(~esc).any(), esc.any(), esc.sum(),
                             p["partial"].sum()]).to(I32),
        bits=torch.stack([esc, p["err"]]),
        lanes=torch.stack(rows).to(I32),
        coefs=torch.stack([c for *_, c in p["params"]]).to(I32))
