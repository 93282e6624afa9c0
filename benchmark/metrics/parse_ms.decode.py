"""parse_ms.decode: device ms per decode call in the parse kernel (one
launch per element: the header, the partial-frame field, the mix token,
each channel's params and coefficients), the per-packet stage that short
packets multiply relative to samples."""

PARSE = r"\bparse_kernel"


def read(t):
    measured = t.kernel_s(PARSE)
    if not t.calls or not measured:
        return None
    return measured / t.calls * 1e3
