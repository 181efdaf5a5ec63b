"""Fitted trace cost model (the batch-sizing subsystem;
rtk_tpu.utils.costmodel in PyTorch, fitted on an H100).

The reference exposes per-task cost estimates as host-scheduler hints
(rtk.h:112, constants rtk.c:1664-1667).  This module carries them to the
card with the reference's formula, names and signatures:

    t_step = A * P + B * P * PKT + C          [microseconds]
    trace_ms = max(1, n // (P * PKT)) * steps_per_block * t_step / 1e3
               + DISPATCH_MS

On the card the kernel runs one thread per ray in blocks of 128
(csrc/packet_trace.cu, __launch_bounds__(128, 10)), so a "packet" of PKT
rays is the model's unit of account, not a kernel parameter.
steps_per_block is the port's own statistic (utils/stats.py:
steps_per_block, the mean over 128-ray blocks of the block's largest pop
count, read from the stats variant on unsorted rays, as
measure_trace(with_steps=True) reads it): it differs from the TPU's
per-block steps and is not comparable with them.  B is the cost of one
ray-step of the whole call (coherence key, sort, gather, kernel,
unsort).  With P held at 8, as in the fit, A * P + C is one per-packet-
step term: the fit reports it as C, and A is 0 (the card has no
per-packet scalar chain).  DISPATCH_MS is the fixed cost of one call:
the formula's intercept over the sizes that fill the card, the host's
share of a call with the card's own cost that does not grow with the
rays (the traversal's depth-bound latency, the sort's passes).

On the fit's sizes the model gives the median walls back within 3%.
Below 1024^2 the card is not full: a sorted call's wall is its 0.3-0.5
ms busy time and 0.2-0.4 ms of the host's, and the model over-predicts
128^2 by about a quarter.  At 1024^2 the call is bound by the card in
most processes (wall = busy + 0.1 ms); a process whose host is slowed
while it runs, by other work on the machine, can take half as long again
(PERF.md section 6).

dispatch_bound() says whether a batch is too small for the card: its
predicted device time is below the fixed cost, so the caller should batch
more rays per call rather than tune the kernel.  auto_pkt() returns the
width that misaligns nothing (see its docstring).

Every constant below is the card's own, from one run of
tools/torch_costmodel_fit.py; none is the reference's TPU v5e fit.
"""
from __future__ import annotations

import dataclasses

from rtk_tpu_torch.ops.packet_trace import PKT

# Fitted on an NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi name and
# power.limit), blob(6) (81,920 tris, build_scene: LBVH leaf 4), Morton
# primaries through Tracer.closest at 1024^2, 2048^2, 4096^2 and 8192^2
# (the sizes that fill the card): each size's host wall ms of one
# synchronised call (median of 31 calls, then of 5 processes), least
# squares in relative error at P = 8, PKT = 128 and 512, together with
# DISPATCH_MS, by tools/torch_costmodel_fit.py.  The fit's C was 2.8e-18:
# 0.
A_US = 0.0
B_US = 2.2275e-5
C_US = 0.0

# The fixed cost of one Tracer.closest call: the same fit's intercept
# (same card, sweep and script).  The host's share alone, the wall less
# the card's busy ms at 128^2 (16,384 rays, the smallest batch the front
# end coherence-sorts), was 0.2563 ms in that fit.  A batch below 16,384
# rays skips the sort and costs less (0.30 ms at 64^2, of which the card
# is busy 0.21), so trace_ms over-predicts such batches; dispatch_bound's
# answer for them is the same.
DISPATCH_MS = 0.3986


@dataclasses.dataclass(frozen=True)
class StepModel:
    """t_step(P, PKT) in microseconds plus derived whole-trace estimates."""

    a_us: float = A_US
    b_us: float = B_US
    c_us: float = C_US

    def step_us(self, p: int, pkt: int) -> float:
        return self.a_us * p + self.b_us * p * pkt + self.c_us

    def trace_ms(self, n_rays: int, pkt: int, steps_per_block: float,
                 p: int = 8) -> float:
        """Predicted host wall time of one synchronised Tracer.closest
        call.

        steps_per_block: per-scene traversal depth statistic (measure with
        measure_trace(with_steps=True), or trace_packets(stats=True) and
        utils/stats.py's steps_per_block on the counts' first row).
        """
        blocks = max(1, n_rays // (p * pkt))
        return blocks * steps_per_block * self.step_us(p, pkt) / 1e3 \
            + DISPATCH_MS


def auto_pkt(n_rays: int, p: int = 8) -> int:
    """The packet width for a ray batch: 128 at every size.

    On this card pkt selects nothing in the kernel; it only sets the unit
    in which trace_packets lays out packet_roots.  trace_packets with
    pkt=128 and pkt=2048 take the same time within noise at 1024^2 and
    8192^2 (tools/torch_costmodel_fit.py), so the measured-best width is
    any width, and this returns the one that misaligns nothing: the
    layout packet_roots uses by default (ops/packet_trace.py PKT).
    """
    return PKT


def dispatch_bound(n_rays: int, pkt: int | None = None,
                   steps_per_block: float = 21.16) -> bool:
    """True when fixed dispatch cost exceeds predicted device time —
    the caller should batch more rays per call, not tune the kernel.

    steps_per_block defaults to what blob(6) Morton primaries run at
    1024^2 on unsorted rays (the fit's run), as the reference's 34.0 was
    the TPU's for the same class of scene at 1M rays."""
    pkt = auto_pkt(n_rays) if pkt is None else pkt
    model = StepModel()
    device_ms = model.trace_ms(n_rays, pkt, steps_per_block) - DISPATCH_MS
    return device_ms < DISPATCH_MS
