"""What every traffic kind shares: the run's context, the choice of the
window's calls whose outputs are kept for the check, and the closed
loop that fills the window."""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from ..ref import codec as rc
from .inputs import generator


@dataclasses.dataclass
class Context:
    seed: int
    device: str
    config: dict          # the configuration file
    params: dict          # the traffic mix file
    layout: rc.Layout
    port_config: object   # the port's AlacConfig of the configuration


def layout(config: dict) -> rc.Layout:
    return rc.Layout(bit_depth=config["bit_depth"],
                     frame_length=config["frame_length"],
                     elements=tuple((t, w) for t, w in config["elements"]),
                     mb=config["mb"], pb=config["pb"], kb=config["kb"])


def port_config(config: dict):
    """The port's AlacConfig for a configuration file; its element layout
    must be the file's."""
    from alacjax_torch.types import AlacConfig
    cfg = AlacConfig(bit_depth=config["bit_depth"],
                     num_channels=config["num_channels"],
                     frame_length=config["frame_length"],
                     sample_rate=config["sample_rate"], mb=config["mb"],
                     pb=config["pb"], kb=config["kb"],
                     search=config["search"])
    got = [(t.name, w) for t, w in cfg.elements]
    if got != [tuple(e) for e in config["elements"]]:
        raise ValueError(f"the port lays out {got}, the configuration "
                         f"{config['elements']}")
    return cfg


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Keeper:
    """The calls whose outputs the check compares: the first ``first``,
    ``early`` drawn from the seed among calls [first, horizon), and the
    window's last call."""

    def __init__(self, seed: int, first: int = 2, early: int = 2,
                 horizon: int = 64):
        g = generator(seed, 97, "cpu")
        pick = torch.randperm(horizon - first, generator=g)[:early] + first
        self.indices = set(range(first)) | set(pick.tolist())
        self.kept = {}
        self.last = None

    def offer(self, i: int, value) -> None:
        if i in self.indices:
            self.kept[i] = value
        self.last = (i, value)

    def outputs(self) -> dict:
        out = dict(self.kept)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


def closed_loop(seconds: float, tracer, step, device):
    """Call ``step(i)`` back to back until ``seconds`` have passed, inside
    the ``window`` span, and close with one synchronize.  Returns (calls,
    window seconds)."""
    i = 0
    ends = []
    with tracer.span("window"):
        t0 = time.perf_counter()
        while True:
            step(i)
            i += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        sync(device)
        dt = time.perf_counter() - t0
    # how the window's calls spread on the host's clock (a diagnostic):
    # the ms between successive returns, in quartiles, and the rate in
    # each fifth of the window
    gaps = sorted(b - a for a, b in zip([0.0] + ends[:-1], ends))
    q = [gaps[int(f * (len(gaps) - 1))] * 1e3 for f in (0.25, 0.5, 0.75)]
    fifths = [sum(1 for e in ends if k * dt / 5 <= e < (k + 1) * dt / 5)
              for k in range(5)]
    print(f"[bench] window: {i} calls, ms between returns (quartiles) "
          f"{q}, calls per fifth {fifths}", file=sys.stderr)
    return i, dt
