"""Plain ALAC arithmetic for the benchmark's reference, vectorised across
lanes in plain torch (any device): bit fields in word images, the
adaptive FIR predictor and its inverse, the adaptive Golomb-Rice coder
and decoder, and the stereo matrix.

Written from Apple's ALAC sources (codec/dp_enc.c, dp_dec.c, ag_enc.c,
ag_dec.c, matrix_enc.c, matrix_dec.c, aglib.h, dplib.h) in the repo's
dialect; it imports nothing of the package under test.  Every tensor of
samples, residuals and state is int64; C's int32 and int16 wraps are
applied where the reference's types wrap.  One loop step serves every
lane at once: a lane whose work is done (its sample count reached) takes
no-op steps.  A step changes its state in place and never waits for the
device, so on a card the loop replays it as one captured CUDA graph
(``Steps``); on the CPU it runs step by step.

Word images hold big-endian 32-bit words as int64 values in [0, 2**32):
bit 0 of a packet is bit 31 of word 0.
"""

from __future__ import annotations

import torch

I64 = torch.int64
U32 = 0xFFFFFFFF

# aglib.h
QBSHIFT = 9
QB = 1 << QBSHIFT
PBSHIFT = 9
MMULSHIFT = 2
MDENSHIFT = QBSHIFT - MMULSHIFT - 1
MOFF = 1 << (MDENSHIFT - 2)
BITOFF = 24
MAX_PREFIX = 9                 # MAX_PREFIX_16 == MAX_PREFIX_32
RUN_ESCAPE_BITS = 16           # MAX_DATATYPE_BITS_16
MAX_RICE_NUMBITS = 25          # ag_enc.c :: dyn_code_32bit's codeword cap
N_MAX_MEAN_CLAMP = 0xFFFF
N_MEAN_CLAMP_VAL = 0xFFFF
MAX_RUN = 65535                # ag_enc.c: a zero run stops at 65535
CODE_BITS = MAX_PREFIX + 17    # the longest codeword at chanbits <= 17
# dplib.h
DENSHIFT = 9
AINIT, BINIT, CINIT = 38, -29, -2
# element tags (ALACAudioTypes.h)
ID_SCE, ID_CPE, ID_LFE, ID_END = 0, 1, 3, 7


class Steps:
    """Runs ``step`` (a function that updates tensors in place) again and
    again: on a card as one captured CUDA graph replayed, elsewhere
    eagerly.  The first step runs eagerly, which also warms the caching
    allocator before the capture."""

    def __init__(self, step, device):
        self.step = step
        self.graph = None
        self.pending = 1          # the eager first step, not yet run
        self.device = torch.device(device)

    def run(self, n: int) -> None:
        if n <= 0:
            return
        if self.pending:
            self.pending = 0
            if self.device.type == "cuda":
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    self.step()
                torch.cuda.current_stream(self.device).wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self.step()
            else:
                self.step()
            n -= 1
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.step()


def sext(x, bits):
    """The low ``bits`` bits of ``x`` as a signed value: C's
    ``(x << (32 - bits)) >> (32 - bits)`` (``bits`` an int or a tensor
    broadcasting against ``x``)."""
    m = torch.bitwise_left_shift(torch.ones_like(x), bits)
    x = x & (m - 1)
    return torch.where(x >= (m >> 1), x - m, x)


def wrap32(x):
    return sext(x, 32)


def wrap16(x):
    return sext(x, 16)


def lead32(x):
    """Leading zero bits of each 32-bit value of ``x`` (lead(0) == 32)."""
    _, e = torch.frexp(x.to(torch.float64))
    return torch.where(x == 0, 32, 32 - e.to(I64))


def lg3a(x):
    return 31 - lead32(x + 3)


def init_coefs(L: int, taps: int, device):
    """dp_enc.c :: init_coefs at DENSHIFT, ``taps`` wide, for L lanes."""
    c = torch.zeros((L, taps), dtype=I64, device=device)
    den = 1 << DENSHIFT
    c[:, 0] = (AINIT * den) >> 4
    c[:, 1] = (BINIT * den) >> 4
    c[:, 2] = (CINIT * den) >> 4
    return c


# ---------------------------------------------------------------------------
# bit fields
# ---------------------------------------------------------------------------
def put_bits(img, row, pos, value, nbits):
    """Write ``value`` (nbits <= 32 bits, MSB first) at bit ``pos`` of word
    image row ``row``, for every element of the broadcast arguments.
    Fields never overlap, so an add is an OR, and fields that share a
    word add into it together."""
    W = img.shape[1]
    row, pos, value, nbits = torch.broadcast_tensors(
        row.to(I64), pos.to(I64), value.to(I64), nbits.to(I64))
    row, pos, value, nbits = (t.reshape(-1) for t in (row, pos, value, nbits))
    w = pos >> 5
    off = pos & 31
    hi_n = torch.minimum(nbits, 32 - off)
    lo_n = nbits - hi_n
    hi = torch.bitwise_left_shift(torch.bitwise_right_shift(value, lo_n),
                                  32 - off - hi_n)
    lo = torch.bitwise_left_shift(
        value & (torch.bitwise_left_shift(torch.ones_like(lo_n), lo_n) - 1),
        32 - lo_n)
    lo = torch.where(lo_n > 0, lo, 0)
    flat = img.view(-1)
    base = row * W
    flat.index_add_(0, base + torch.clamp(w, max=W - 1),
                    torch.where(nbits > 0, hi, 0))
    flat.index_add_(0, base + torch.clamp(w + 1, max=W - 1), lo)


def peek32(img, row, pos):
    """The 32 bits of each row's image starting at bit ``pos``."""
    W = img.shape[1]
    w = pos >> 5
    off = pos & 31
    a = img[row, torch.clamp(w, max=W - 1)]
    b = img[row, torch.clamp(w + 1, max=W - 1)]
    b = torch.where(w + 1 < W, b, 0)
    return ((a << off) & U32) | (b >> (32 - off))


def get_bits(img, row, pos, nbits):
    """``nbits`` (0 to 32) bits at ``pos``, as an unsigned value."""
    return peek32(img, row, pos) >> (32 - nbits)


def splice(img, rows, starts, scratch, nbits):
    """Copy each lane's bit stream (``scratch`` row, from bit 0, ``nbits``
    long) into word image row ``rows`` from bit ``starts``."""
    W = img.shape[1]
    L, Wc = scratch.shape
    dev = img.device
    src = torch.cat([torch.zeros((L, 1), dtype=I64, device=dev), scratch,
                     torch.zeros((L, 1), dtype=I64, device=dev)], 1)
    off = (starts & 31)[:, None]
    moved = (src[:, 1:] >> off) | ((src[:, :-1] << (32 - off)) & U32)
    col = (starts >> 5)[:, None] + torch.arange(Wc + 1, device=dev)[None, :]
    need = torch.arange(Wc + 1, device=dev)[None, :] <= (
        (nbits[:, None] + off + 31) >> 5)
    keep = need & (col < W)
    idx = rows[:, None] * W + torch.clamp(col, max=W - 1)
    img.view(-1).index_add_(0, idx[keep], moved[keep])


# ---------------------------------------------------------------------------
# the adaptive FIR predictor (dp_enc.c :: pc_block, dp_dec.c :: unpc_block)
# ---------------------------------------------------------------------------
def fir(data, order, coefs, chanbits, num, decode: bool):
    """Forward (``decode`` False: samples -> residuals, pc_block) or inverse
    (residuals -> samples, unpc_block) prediction of (L, N) lanes at
    per-lane ``order`` (1 to 30 taps), from (L, >= order) starting
    ``coefs`` at DENSHIFT, over each lane's first ``num`` samples.
    Returns (output (L, N), adapted coefficients (L, T), walk steps per
    lane)."""
    L, N = data.shape
    dev = data.device
    T = max(int(order.max().item()) if L else 1, 1)
    order = order.to(I64)
    w = torch.arange(T, device=dev)
    kmask = w[None, :] < order[:, None]
    # the walk runs from the highest tap down: column w holds tap
    # k = order - 1 - w, whose weight numactive - k is w + 1
    tap = torch.clamp(order[:, None] - 1 - w[None, :], min=0)
    c = torch.where(kmask, coefs.to(I64).gather(1, tap), 0)
    weight = (w + 1)[None, :]
    xp = torch.zeros((L, N + T + 1), dtype=I64, device=dev)
    out = torch.zeros((L, N), dtype=I64, device=dev)
    out[:, 0] = data[:, 0]
    if decode:
        xp[:, T + 1] = data[:, 0]
    else:
        xp[:, T + 1:] = data
    U = xp.unfold(1, T + 1, 1)            # U[:, j] = x[j-T-1 .. j-1]
    lag_idx = torch.clamp(T + 1 - order[:, None] + w[None, :], max=T)
    top_idx = (T - order)[:, None]
    cb = chanbits.to(I64)
    steps = torch.zeros((L, T), dtype=I64, device=dev)
    jt = torch.ones((1,), dtype=I64, device=dev)
    denhalf = 1 << (DENSHIFT - 1)

    def step():
        row = U.index_select(1, jt)[:, 0]          # x[j-T-1 .. j-1]
        lags = row.gather(1, lag_idx)             # x[j-1-k], walk order
        top = row.gather(1, top_idx)[:, 0]        # x[j-1-order]
        prev = row[:, T]
        D = torch.where(kmask, lags - top[:, None], 0)
        pred = wrap32(denhalf + (c * D).sum(1)) >> DENSHIFT
        warm = jt <= order
        live = jt < num
        r = data.index_select(1, jt)[:, 0]
        if decode:
            y = torch.where(warm, sext(r + prev, cb),
                            sext(r + top + pred, cb))
            y = torch.where(live, y, 0)
            xp.index_copy_(1, jt + T + 1, y[:, None])
            out.index_copy_(1, jt, y[:, None])
            res = r
        else:
            res = torch.where(warm, sext(r - prev, cb),
                              sext(r - top - pred, cb))
            out.index_copy_(1, jt, torch.where(live, res, 0)[:, None])
        s = torch.where(live & ~warm, torch.sign(res), 0)[:, None]
        dd = -D                                   # top - x[j-1-k]
        sg = torch.sign(dd)
        contrib = weight * ((s * sg * dd) >> DENSHIFT)
        # del0 after the step at w; the walk stops after the first w at
        # which s * del0 is no longer positive
        cont = (s * (res[:, None] - torch.cumsum(contrib, 1))) > 0
        stop = (~cont).to(I64)
        ran = ((torch.cumsum(stop, 1) - stop) == 0) & kmask & (s != 0)
        c.sub_(torch.where(ran, s * sg, 0))
        c.copy_(wrap16(c))
        steps.add_(ran.to(I64))
        jt.add_(1)

    Steps(step, dev).run(N - 1)
    back = torch.clamp(order[:, None] - 1 - w[None, :], min=0)
    coefs_out = torch.where(kmask, c.gather(1, back), 0)
    return out, coefs_out, steps.sum(1)


def first_difference(res, chanbits, num):
    """The second stage of mode 15 (pc_block at numactive 31): each
    residual minus the one before, sign-extended to chanbits."""
    N = res.shape[1]
    d = torch.cat([res[:, :1], sext(res[:, 1:] - res[:, :-1],
                                    chanbits[:, None])], 1)
    live = torch.arange(N, device=res.device)[None, :] < num[:, None]
    return torch.where(live, d, 0)


def running_sum(d, chanbits, num):
    """unpc_block at numactive 31: the running sum, sign-extended at every
    step (modular, so one cumulative sum)."""
    N = d.shape[1]
    live = torch.arange(N, device=d.device)[None, :] < num[:, None]
    return torch.where(live, sext(torch.cumsum(d, 1), chanbits[:, None]), 0)


# ---------------------------------------------------------------------------
# the adaptive Golomb-Rice coder (ag_enc.c :: dyn_comp, ag_dec.c :: dyn_decomp)
# ---------------------------------------------------------------------------
def _code(n, m, k, esc_bits, capped):
    """The codeword of n for modulus m = 2**k - 1 (dyn_code_32bit when
    ``capped``, escaping to ``esc_bits`` raw bits; dyn_code for a zero run
    at 16): (value, number of bits)."""
    div = n // m
    mod = n - m * div
    de = (mod == 0).to(I64)
    divc = torch.clamp(div, max=MAX_PREFIX)
    nb = divc + k + 1 - de
    ones = torch.bitwise_left_shift(torch.ones_like(n), divc) - 1
    val = torch.bitwise_left_shift(ones, nb - divc) + mod + 1 - de
    esc = (div >= MAX_PREFIX) | (capped & (nb > MAX_RICE_NUMBITS))
    escv = torch.bitwise_left_shift(torch.full_like(n, (1 << MAX_PREFIX) - 1),
                                    esc_bits) | n
    return torch.where(esc, escv, val), torch.where(esc, MAX_PREFIX + esc_bits,
                                                    nb)


def _zero_runs(res, num):
    """(L, N + 1): the zeros that follow from each sample position within
    the lane's first ``num`` samples."""
    L, N = res.shape
    dev = res.device
    idx = torch.arange(N + 1, device=dev)
    stop = torch.ones((L, N + 1), dtype=torch.bool, device=dev)
    stop[:, :N] = res != 0
    stop = stop | (idx[None, :] >= num[:, None])
    nxt = torch.where(stop, idx[None, :], N + 1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), 1).values, [1])
    return nxt - idx[None, :]


class _Rice:
    """dyn_comp's / dyn_decomp's per-lane state: the sample index, the
    mean, the zero-run mode and whether a zero-run codeword is next."""

    def __init__(self, L, mb0, dev):
        self.c = torch.zeros((L,), dtype=I64, device=dev)
        self.mb = torch.full((L,), mb0, dtype=I64, device=dev)
        self.zmode = torch.zeros((L,), dtype=I64, device=dev)
        self.pend = torch.zeros((L,), dtype=torch.bool, device=dev)

    def params(self, kb: int, wb: int):
        """(k, m) of a value codeword and (kz, mz) of a zero-run one."""
        k = torch.clamp(lg3a(self.mb >> QBSHIFT), max=kb)
        m = torch.bitwise_left_shift(torch.ones_like(k), k) - 1
        kz = lead32(self.mb) - BITOFF + ((self.mb + MOFF) >> MDENSHIFT)
        kz = torch.clamp(kz, 1, 31)
        mz = (torch.bitwise_left_shift(torch.ones_like(kz), kz) - 1) & wb
        return k, m, kz, torch.clamp(mz, min=1)

    def advance(self, isval, isrun, n, nz, num, pb):
        """The state after a value codeword (``isval``: folded value n) or
        a zero-run codeword (``isrun``: nz zeros)."""
        zm = self.zmode
        mbv = (pb * (n + zm) + self.mb - ((pb * self.mb) >> PBSHIFT)) & U32
        mbv = torch.where(n > N_MAX_MEAN_CLAMP, N_MEAN_CLAMP_VAL, mbv)
        cv = self.c + 1
        pendv = (((mbv << MMULSHIFT) & U32) < QB) & (cv < num)
        self.c.copy_(torch.where(isval, cv, torch.where(isrun, self.c + nz,
                                                        self.c)))
        self.mb.copy_(torch.where(isval, mbv, torch.where(isrun, 0, self.mb)))
        self.zmode.copy_(torch.where(isval, 0, torch.where(
            isrun, (nz < MAX_RUN).to(I64), zm)))
        self.pend.copy_(torch.where(isval, pendv,
                                    torch.where(isrun, False, self.pend)))

    def busy(self, num) -> bool:
        return bool(((self.c < num) | self.pend).any().item())


def _until_done(steps: Steps, state: _Rice, num) -> None:
    while state.busy(num):
        steps.run(64)


def rice_encode(res, num, chanbits, mb0: int, pb: int, kb: int, img=None):
    """dyn_comp over (L, N) residuals, each lane over its first ``num``:
    returns (bits, coded samples) per lane.  With ``img`` (L, W), lane l's
    codewords are also written into row l from bit 0."""
    L, N = res.shape
    dev = res.device
    wb = (1 << kb) - 1
    zr = _zero_runs(res, num)
    st = _Rice(L, mb0, dev)
    bits = torch.zeros((L,), dtype=I64, device=dev)
    coded = torch.zeros((L,), dtype=I64, device=dev)
    cb = chanbits.to(I64)
    rows = torch.arange(L, device=dev)

    def step():
        isrun = st.pend
        isval = (st.c < num) & ~isrun
        cc = torch.clamp(st.c, max=N - 1)[:, None]
        k, m, kz, mz = st.params(kb, wb)
        d = res.gather(1, cc)[:, 0]
        n = ((d.abs() << 1) - (d < 0).to(I64) - st.zmode) & U32
        nz = torch.clamp(zr.gather(1, cc)[:, 0], max=MAX_RUN)
        val, nb = _code(torch.where(isrun, nz, n), torch.where(isrun, mz, m),
                        torch.where(isrun, kz, k),
                        torch.where(isrun, RUN_ESCAPE_BITS, cb), ~isrun)
        nb = torch.where(isrun | isval, nb, 0)
        if img is not None:
            put_bits(img, rows, bits, torch.where(nb > 0, val, 0), nb)
        bits.add_(nb)
        coded.add_(isval.to(I64))
        st.advance(isval, isrun, n, nz, num, pb)

    _until_done(Steps(step, dev), st, num)
    return bits, coded


def _get_code(img, row, pos, m, k, esc_bits):
    """dyn_get_32bit / dyn_get: (value, bits consumed) at ``pos``."""
    stream = peek32(img, row, pos)
    pre = lead32((~stream) & U32)
    v = ((stream << (torch.clamp(pre, max=MAX_PREFIX - 1) + 1)) & U32) \
        >> (32 - k)
    big = v >= 2
    res = pre * m + torch.where(big, v - 1, 0)
    used = pre + 1 + torch.where(big, k, k - 1)
    esc = pre >= MAX_PREFIX
    escv = get_bits(img, row, pos + MAX_PREFIX, esc_bits)
    return (torch.where(esc, escv, res),
            torch.where(esc, MAX_PREFIX + esc_bits, used))


def rice_decode(img, row, start, num, chanbits, N: int, mb0: int, pb, kb: int):
    """dyn_decomp for lanes reading word image rows ``row`` from bit
    ``start``, ``num`` residuals each: returns ((L, N) residuals, end bit,
    error flag).  A zero run past the lane's count flags the lane."""
    L = row.shape[0]
    dev = img.device
    wb = (1 << kb) - 1
    out = torch.zeros((L, N), dtype=I64, device=dev)
    pos = start.to(I64).clone()
    err = torch.zeros((L,), dtype=torch.bool, device=dev)
    st = _Rice(L, mb0, dev)
    cb = chanbits.to(I64)
    lanes = torch.arange(L, device=dev)

    def step():
        isrun = st.pend
        isval = (st.c < num) & ~isrun
        k, m, kz, mz = st.params(kb, wb)
        got, used = _get_code(img, row, pos, torch.where(isrun, mz, m),
                              torch.where(isrun, kz, k),
                              torch.where(isrun, RUN_ESCAPE_BITS, cb))
        n = torch.where(isval, got, 0)
        nz = torch.where(isrun, got, 0)
        nd = n + st.zmode
        d = ((nd + 1) >> 1) * ((-(nd & 1)) | 1)
        cc = torch.clamp(st.c, max=N - 1)
        out.index_put_((lanes, cc), torch.where(isval, d, out[lanes, cc]))
        pos.add_(torch.where(isval | isrun, used, 0))
        err.copy_(err | (isrun & (st.c + nz > num)))
        st.advance(isval, isrun, n, nz, num, pb)

    _until_done(Steps(step, dev), st, num)
    return out, pos, err


# ---------------------------------------------------------------------------
# the stereo matrix (matrix_enc.c :: mix*, matrix_dec.c :: unmix*)
# ---------------------------------------------------------------------------
def mix(left, right, mixbits: int, mixres):
    """(U, V) of a CPE; ``mixres`` a per-lane (L,) tensor (0: U = L, V = R)."""
    r = mixres[:, None]
    u = wrap32(r * left + ((1 << mixbits) - r) * right) >> mixbits
    v = wrap32(left - right)
    return torch.where(r == 0, left, u), torch.where(r == 0, right, v)


def unmix(u, v, mixbits, mixres):
    r = mixres[:, None]
    b = mixbits[:, None]
    rr = wrap32(u - (wrap32(r * v) >> b))
    ll = wrap32(v + rr)
    return torch.where(r == 0, u, ll), torch.where(r == 0, v, rr)
