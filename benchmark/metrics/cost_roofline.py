"""cost_roofline: the cost kernel's launches (the mixres trial and the
search), the least seconds their work needs over their measured
seconds, in per cent."""

from benchmark.lib import readers


def read(t):
    return readers.roofline(t, "cost", r"\bcost_tiled<")
