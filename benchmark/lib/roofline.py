"""The least time the card could take for a kernel's work: the longer of
its bytes at the memory's rate and its operations at the SMs' issue
rate.  The constants are frozen copies of chip_smoke.py's (lines
265-298), with their reasons; the counts that depend on the data (coded
samples, the predictor's walk steps) come from the benchmark's own
reference over the same inputs, never from the port."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12    # one H100 SXM's device memory rate
# Lane operations one Hopper SM issues per clock: four schedulers, each
# one warp instruction (32 lanes) a clock, whatever the pipe.  The scans'
# multiply-adds go down the FMA pipe and their adds, logic, shifts and
# selects down the ALU pipe, side by side, so for their mix the issue
# rate is the ceiling (ALU operations alone would be held to 64).
LANE_OPS_PER_SM_CLOCK = 128
# Operations one lane-sample of a scan needs, counted from the
# reference's arithmetic (dp_enc.c / dp_dec.c, ag_enc.c / ag_dec.c; a
# multiply-add, a three-input add and a sign extension are one operation
# each), whatever the kernel issues.
FIR_PER_TAP = 2      # per tap of the lane's order: lag difference, multiply-add
FIR_FIXED = 4        # per sample past the warm-up: the rounding shift, the
                     # residual's add, its sign extension, its sign
WALK_STEP = 8        # per walk step: the difference's sign (2), the
                     # coefficient's step and 16-bit wrap (2), |d|, the
                     # shift, the weighted multiply-subtract, the side test
RICE_PRICE = 30      # per coded sample of a cost machine: k (4), m (2), the
                     # folded value (3), the capped quotient and remainder
                     # (3), the length (3), the escape test and length (4),
                     # the running sum (1), the mean's update and clamp (6),
                     # the zero-run test and state (4)
RICE_DECODE = 36     # per decoded sample: k (4), m (2), 32 bits cut at the
                     # cursor (3), the prefix (2), the suffix (3), the
                     # escape test (1), n (3), the cursor's advance (4),
                     # the unfolded residual (4), the mean (6), the
                     # zero-run test (4)
RICE_IDLE = 3        # per sample inside a zero run
DIFF_STAGE = 2       # per sample of a first difference or running sum
I32 = 4


def max_sm_clock_hz() -> float:
    """The SM clock's maximum as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.split()[0]) * 1e6


def seconds(nbytes: float, ops: float, sms: int, clock_hz: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S,
               ops / (sms * LANE_OPS_PER_SM_CLOCK * clock_hz))


def decode_launch(num, order, mode, coded, steps, rice_bits, S: int):
    """(bytes, operations) of one 8-tap decode launch over lanes with
    these per-lane sample counts, orders, modes, coded samples, walk steps
    and Rice bits (all int64 tensors): the bits the lanes consume and the
    samples they write, the per-lane parameters (start, end, error,
    count, 16 coefficients, mode, order, denshift, pb), and the
    operations of the Rice decode, the walk and the FIR."""
    L = num.shape[0]
    nbytes = (int(rice_bits.sum().item()) // 8 + L * S * I32
              + L * I32 * (4 + 16 + 4) + L)
    past = (num - order - 1).clamp(min=0)
    ops = (RICE_DECODE * coded + RICE_IDLE * (num - coded)
           + WALK_STEP * steps + past * (FIR_PER_TAP * order + FIR_FIXED)
           + DIFF_STAGE * num * (mode != 0))
    return nbytes, int(ops.sum().item())


def cost_launch(lanes: int, S: int, orders, dual: bool, samples: int,
                steps: int, coded: int):
    """(bytes, operations) of one cost launch: ``lanes`` lanes of S
    samples priced at ``orders`` with one machine (the trial) or two (the
    search: the residuals and their first difference); ``samples`` the
    lane-samples inside the counts, ``steps`` and ``coded`` the walk steps
    and coded samples summed over the orders and machines.  Bytes: the
    samples, starting coefficients and per-lane widths in; per order the
    residuals, two costs and the adapted coefficients out."""
    n = len(orders)
    machines = 2 if dual else 1
    nbytes = (lanes * S * I32 + lanes * 16 * I32 + lanes * I32
              + n * lanes * (S + 2 + 16) * I32)
    ops = sum(lanes * max(S - od - 1, 0) * (FIR_PER_TAP * od + FIR_FIXED)
              for od in orders)
    ops += WALK_STEP * steps + n * (machines - 1) * DIFF_STAGE * samples
    ops += RICE_PRICE * coded + RICE_IDLE * (n * machines * samples - coded)
    return nbytes, ops
