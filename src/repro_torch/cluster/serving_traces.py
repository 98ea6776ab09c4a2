"""Diurnal request-rate traces for serving workloads (paper §7 MLaaS).

The port's own copy of ``repro/cluster/serving_traces.py``: plain Python on plain
values, no tensors, no device.  It imports nothing of ``repro``.

Inference traffic is qualitatively different from the training submit
streams in :mod:`trace`: request rates swing with the day/night cycle
("serves heavy traffic from millions of users") and carry bursty noise
on top.  This module generates the *rate* signal as a stream of
:class:`~repro_torch.cluster.events.RateUpdate` events — one per sampling
interval — that drive the scheduler's per-service M/M/c queue model and
the autoscaler.

The deterministic part is a sum of sinusoids over a base rate:

    r(t) = base * (1 + sum_i a_i * sin(2*pi*t/T_i + phi_i))

Each emitted sample is the *interval average* of ``r`` — derived from
the closed-form cumulative integral ``Lambda(t)`` — so the rate
integral is conserved exactly: with bursts off, ``sum(rate * dt)``
equals ``mean_diurnal_rate(profile, D) * D`` to float precision
(the reference's ``tests/test_serving.py`` asserts this).  Bursty noise is a
seeded multiplicative spike process (geometric decay) layered on top; like
every generator in :mod:`trace` the stream is a pure function of its
arguments — one ``random.Random(seed)``, no wall clock.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterator, List, Tuple

from .events import RateUpdate

# seed-mixing constant, same idiom as trace.iter_failure_trace: decouples
# the burst stream from any other generator sharing the caller's seed
_BURST_SALT = 0x5E81C0DE


@dataclasses.dataclass(frozen=True)
class DiurnalProfile:
    """Sum-of-sinusoids request-rate profile.

    ``harmonics`` entries are ``(amplitude_fraction, period_s,
    phase_rad)``; amplitude fractions should sum below 1.0 so the rate
    stays nonnegative (the default daily + half-day pair sums to 0.7,
    with the trough at t=0 so traces start in the quiet hours).
    """

    base_rps: float = 8.0
    harmonics: Tuple[Tuple[float, float, float], ...] = (
        (0.5, 86400.0, -math.pi / 2.0),   # daily swing, trough at t=0
        (0.2, 43200.0, 0.0),              # half-day harmonic
    )


def diurnal_rate(profile: DiurnalProfile, t: float) -> float:
    """Instantaneous request rate ``r(t)`` in requests/s."""
    r = 1.0
    for amp, period, phase in profile.harmonics:
        r += amp * math.sin(2.0 * math.pi * t / period + phase)
    return profile.base_rps * max(0.0, r)


def cumulative_requests(profile: DiurnalProfile, t: float) -> float:
    """Closed-form ``Lambda(t) = integral of r`` over ``[0, t]``.

    Valid when the harmonic amplitudes sum below 1 (the rate never
    clamps); each sinusoid integrates to ``-a * (T/2pi) * cos(...)``.
    """
    total = t
    for amp, period, phase in profile.harmonics:
        w = 2.0 * math.pi / period
        total -= (amp / w) * (math.cos(w * t + phase) - math.cos(phase))
    return profile.base_rps * total


def mean_diurnal_rate(profile: DiurnalProfile, duration_s: float) -> float:
    """Closed-form time-average of the rate over ``[0, duration_s]``."""
    if duration_s <= 0:
        return 0.0
    return cumulative_requests(profile, duration_s) / duration_s


def iter_diurnal_trace(
    *,
    service_id: int,
    seed: int = 0,
    duration_s: float = 24 * 3600.0,
    interval_s: float = 300.0,
    profile: DiurnalProfile = DiurnalProfile(),
    burst_prob: float = 0.0,
    burst_mult: float = 3.0,
    burst_decay: float = 0.5,
) -> Iterator[RateUpdate]:
    """Lazily stream :class:`RateUpdate` events for one service.

    One event per ``interval_s`` bin carrying the bin-averaged diurnal
    rate (exact, from :func:`cumulative_requests`); with probability
    ``burst_prob`` per bin a multiplicative spike up to ``burst_mult``x
    ignites and decays geometrically by ``burst_decay`` per bin.  A
    closing zero-rate sample at ``duration_s`` marks the horizon so the
    scheduler's piecewise-constant queue accounting covers the last bin.
    The default ``burst_prob=0.0`` draws nothing from the RNG, keeping
    the stream exactly the closed-form signal.
    """
    if interval_s <= 0:
        raise ValueError(f"interval_s must be positive, got {interval_s}")
    rng = random.Random(seed ^ _BURST_SALT)
    burst = 0.0
    t = 0.0
    while t < duration_s:
        t1 = min(t + interval_s, duration_s)
        lam = (
            cumulative_requests(profile, t1) - cumulative_requests(profile, t)
        ) / (t1 - t)
        if burst_prob > 0.0:
            if rng.random() < burst_prob:
                burst = max(burst, (burst_mult - 1.0) * rng.random())
            lam *= 1.0 + burst
            burst *= burst_decay
        yield RateUpdate(time=t, service_id=service_id, rate_rps=lam)
        t = t1
    yield RateUpdate(time=duration_s, service_id=service_id, rate_rps=0.0)


def diurnal_trace(**kwargs) -> List[RateUpdate]:
    """Materialized :func:`iter_diurnal_trace` (same arguments)."""
    return list(iter_diurnal_trace(**kwargs))
