"""Distance estimation between contig pairs by maximum likelihood.

Port of abyss_tpu/align/distance_est.py.  Reimplements
DistanceEst/{DistanceEst.cpp,MLE.cpp} and
Common/PMF.h: the empirical fragment-size PMF from the .hist file, the
trapezoid window correcting for length-biased fragment sampling
(MLE.cpp:15-37), the per-theta normalization constant, and the Hann
smoothing filter over the likelihood curve (MLE.cpp:120-155).

The theta scan is device-batched across contig pairs: groups are
bucketed by (sample count, theta range) into padded [G, T, n] float64
tensors, the per-theta window normalization c(theta) is computed in
O(1) per theta from pmf prefix sums (the trapezoid is piecewise linear,
so each segment is a cumsum difference), and the Hann smoothing and the
masked argmax follow, in torch ops on the device (`_mle_scan`).  The
host per-group path (`maximum_likelihood_estimate`) is kept as the
reference formulation, for groups whose theta range is no wider than
the filter, and for workloads of fewer than 64 groups; both produce
identical (d, n).

The card and the CPU compute the same float64 bits: the scan's tables
(log pmf, prefix sums) and the logarithms of the normalization are
taken on the host in numpy, each group's likelihood is summed over its
samples by a fixed pairwise tree (n is a power of two), and the rest
is elementwise IEEE arithmetic, gathers and compares.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core.histogram import Histogram
from .fixmate import PairLink


@dataclass
class PMF:
    probs: np.ndarray
    minp: float
    mean: float
    sd: float

    @staticmethod
    def from_histogram(h: Histogram) -> "PMF":
        n = h.size()
        maxv = h.maximum()
        probs = np.full(maxv + 1, 1.0 / n)
        for k, v in h.counts.items():
            if 0 <= k <= maxv and v > 0:
                probs[k] = v / n
        mean = h.sum() / n
        var = sum(v * (k - mean) ** 2 for k, v in h.counts.items()) / n
        return PMF(probs=probs, minp=1.0 / n, mean=mean, sd=math.sqrt(var))

    @property
    def median(self) -> float:
        """Population median of the fragment-size distribution."""
        c = np.cumsum(self.probs)
        total = c[-1] if len(c) else 0.0
        if total <= 0:
            return self.mean
        return float(np.searchsorted(c, total / 2.0))

    def __getitem__(self, x):
        x = np.asarray(x)
        out = np.where((x >= 0) & (x < len(self.probs)),
                       self.probs[np.clip(x, 0, len(self.probs) - 1)],
                       self.minp)
        return out


def window_fn(x: np.ndarray, len0: int, len1: int) -> np.ndarray:
    """Trapezoid window (MLE.cpp:15-37): fragments spanning a junction are
    length-biased; len0 <= len1."""
    x1, x2, x3 = len0, len1, len0 + len1
    return np.where(
        x <= 0, 1.0,
        np.where(x < x1, x,
                 np.where(x < x2, x1,
                          np.where(x < x3, x3 - x, 1.0)))) / x1


def _hann(size: int) -> np.ndarray:
    i = np.arange(size)
    w = 0.5 * (1 - np.cos(2 * np.pi * i / (size - 1)))
    return w / w.sum()


def maximum_likelihood_estimate(
        samples: list[int], pmf: PMF, len0: int, len1: int,
        first: int, last: int, min_align: int = 32, rf: bool = False,
        ) -> tuple[int, int]:
    """Most likely distance and supporting-pair count (MLE.cpp:98-212).

    samples: observed span-without-gap values; the estimate d maximizes
    the likelihood of fragment sizes (sample + d).
    """
    assert samples
    l = min_align
    len0 = max(len0 - (l - 1), 1)
    len1 = max(len1 - (l - 1), 1)
    if len0 > len1:
        len0, len1 = len1, len0

    adjust = 0 if rf else 2 * (l - 1)
    s = np.asarray(samples) - adjust

    filter_size = 2 * int(0.05 * pmf.mean) + 3
    lo = max(first, -int(s.max())) - filter_size // 2
    hi = min(last, len(pmf.probs) - 1 - int(s.min())) + filter_size // 2 + 1
    if hi <= lo:
        lo, hi = first, first + filter_size + 1
    thetas = np.arange(lo, hi + 1)

    # per-theta normalization: c(theta) = sum_i pmf[i] * window(i - theta)
    i = np.arange(len(pmf.probs))
    w = window_fn(i[None, :] - thetas[:, None], len0, len1)
    c = (pmf.probs[None, :] * w).sum(axis=1)

    p = pmf[s[None, :] + thetas[:, None]]  # [T, n]
    ll = np.log(p).sum(axis=1)
    nsup = (p > pmf.minp).sum(axis=1)
    ll = ll - len(s) * np.log(np.maximum(c, 1e-300))

    filt = _hann(filter_size)
    half = filter_size // 2
    if len(ll) <= filter_size:
        best = int(np.argmax(ll))
        d, n = int(thetas[best]), int(nsup[best])
    else:
        sm = np.convolve(ll, filt, mode="valid")  # length T - 2*half
        cand_n = nsup[half:len(ll) - half]
        sm = np.where(cand_n > 0, sm, -np.inf)
        best = int(np.argmax(sm))
        d, n = int(thetas[best + half]), int(cand_n[best])
    if not rf:
        d = max(first, d - adjust)
    return d, n


def _theta_bounds(s_min, s_max, pmf_len, pmf_mean, first, last):
    """lo/hi/filter geometry shared by the host and batched paths
    (maximum_likelihood_estimate:96-101)."""
    filter_size = 2 * int(0.05 * pmf_mean) + 3
    lo = np.maximum(first, -s_max) - filter_size // 2
    hi = np.minimum(last, pmf_len - 1 - s_min) + filter_size // 2 + 1
    bad = hi <= lo
    lo = np.where(bad, first, lo)
    hi = np.where(bad, first + filter_size + 1, hi)
    return lo, hi, filter_size


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, whose length is a power of two, by halving
    it: the same additions in the same order on every device."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


class _MleTables:
    """The float64 tables of the theta scan for one PMF, on a device,
    built in numpy on the host: pmf, log pmf, and the prefix sums
    P0[j] = sum_{i<j} pmf[i], P1[j] = sum_{i<j} i*pmf[i] (P[0] = 0)."""

    def __init__(self, pmf: PMF, dev: torch.device):
        probs = np.asarray(pmf.probs, np.float64)
        self.I = len(probs)
        self.minp = float(pmf.minp)
        self.log_minp = float(np.log(pmf.minp))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.probs = t(probs)
        self.logp = t(np.log(probs))
        self.P0 = t(np.concatenate([[0.0], np.cumsum(probs)]))
        self.P1 = t(np.concatenate(
            [[0.0], np.cumsum(probs * np.arange(self.I, dtype=np.float64))]))

    def p0(self, j):
        return self.P0[(j + 1).clamp(0, self.I)]

    def p1(self, j):
        return self.P1[(j + 1).clamp(0, self.I)]


def _mle_scan(tab: _MleTables, filter_size: int, T: int, s, smask, lo,
              tcount, x1, x2, x3):
    """The [G, T, n] theta scan of one (T, n) bucket: log-likelihood
    over the samples, prefix-sum window normalization, Hann smoothing,
    masked argmax.  s, smask: [G, n] (n a power of two); lo, tcount,
    x1, x2, x3: int64 [G].  Returns (best_theta, nsup), int64 [G] each.

    The JAX program gathers with clamped indices; every gather here is
    clamped explicitly into the same range."""
    I = tab.I
    dev = s.device
    G = s.shape[0]
    half = filter_size // 2
    theta = lo[:, None] + torch.arange(T, device=dev)[None, :]   # [G, T]
    x = s[:, None, :] + theta[:, :, None]                       # [G, T, n]
    inside = (x >= 0) & (x < I)
    xc = x.clamp(0, I - 1)
    m = smask[:, None, :]
    lp = torch.where(inside, tab.logp[xc], tab.log_minp)
    ll = _tree_sum(torch.where(m, lp, 0.0))                     # [G, T]
    p_gt = torch.where(inside, tab.probs[xc], tab.minp)
    nsup = ((p_gt > tab.minp) & m).sum(dim=2)                   # [G, T]
    del x, inside, xc, lp, p_gt
    nsamp = smask.sum(dim=1).to(torch.float64)                  # [G]

    # c(theta) by prefix sums over the trapezoid's regions
    A = theta
    B = theta + x1[:, None]
    C = theta + x2[:, None]
    D = theta + x3[:, None]
    S1 = tab.p0(A)
    S2 = (tab.p1(B - 1) - tab.p1(A)) - A.to(torch.float64) * \
        (tab.p0(B - 1) - tab.p0(A))
    S3 = x1[:, None].to(torch.float64) * (tab.p0(C - 1) - tab.p0(B - 1))
    S4 = D.to(torch.float64) * (tab.p0(D - 1) - tab.p0(C - 1)) - \
        (tab.p1(D - 1) - tab.p1(C - 1))
    S5 = tab.p0(torch.full_like(A, I - 1)) - tab.p0(D - 1)
    c = (S1 + S2 + S3 + S4 + S5) / x1[:, None].to(torch.float64)
    # the [G, T] logarithms are taken on the host: the card's and the
    # CPU's float64 log may differ in the last bit
    logc = torch.from_numpy(np.log(c.clamp(min=1e-300).cpu().numpy()))
    ll = ll - nsamp[:, None] * logc.to(dev)

    # Hann smoothing along T (valid region), then the masked argmax
    filt = _hann(filter_size)
    sm = torch.zeros((G, T - 2 * half), dtype=torch.float64, device=dev)
    for w in range(filter_size):
        sm = sm + float(filt[w]) * ll[:, w:T - 2 * half + w]
    cand_n = nsup[:, half:T - half]
    tt = torch.arange(sm.shape[1], device=dev)[None, :]
    valid = (tt < (tcount[:, None] - 2 * half).clamp(min=0)) & (cand_n > 0)
    smv = torch.where(valid, sm, -torch.inf)
    best = torch.argmax(smv, dim=1)       # the first maximum, as in JAX
    has = valid.any(dim=1)
    g = torch.arange(G, device=dev)
    return (torch.where(has, lo + best + half, lo),
            torch.where(has, cand_n[g, best], 0))


def estimate_distances_device(groups, pmf: PMF, first: int, last: int,
                              min_align: int = 32,
                              max_batch_elems: int = 64_000_000,
                              device="cuda"):
    """Batched MLE over many contig-pair groups on `device`.

    groups: list of (key, samples, len0, len1).  Returns
    {key: (d, n)} identical to maximum_likelihood_estimate per group.
    Groups whose theta range is no wider than the filter take the host
    path."""
    dev = resolve_device(device)
    out = {}
    l = min_align
    adjust = 2 * (l - 1)
    I = len(pmf.probs)
    prep = []
    for key, samples, len0, len1 in groups:
        s = np.asarray(samples, np.int32) - adjust
        a, b = max(len0 - (l - 1), 1), max(len1 - (l - 1), 1)
        if a > b:
            a, b = b, a
        prep.append((key, s, a, b))

    lo_all, hi_all, filter_size = _theta_bounds(
        np.array([p[1].min() for p in prep], np.int64),
        np.array([p[1].max() for p in prep], np.int64),
        I, pmf.mean, first, last)
    tcount = hi_all - lo_all + 1

    # bucket by padded (T, n)
    buckets: dict[tuple[int, int], list[int]] = {}
    for gi, (key, s, a, b) in enumerate(prep):
        T = int(tcount[gi])
        n = len(s)
        if T <= filter_size:
            # tiny theta range: host path (argmax without smoothing)
            d, cnt = maximum_likelihood_estimate(
                list(s + adjust), pmf, a + (l - 1), b + (l - 1),
                first, last, min_align)
            out[key] = (d, cnt)
            continue
        Tp = 1 << (T - 1).bit_length()
        np_ = 1 << max(n - 1, 1).bit_length()
        buckets.setdefault((Tp, max(np_, 8)), []).append(gi)

    tab = _MleTables(pmf, dev) if buckets else None
    for (Tp, npad), idxs in buckets.items():
        # chunk G to bound [G, T, n] memory
        gchunk = max(1, max_batch_elems // (Tp * npad))
        for c0 in range(0, len(idxs), gchunk):
            sub = idxs[c0:c0 + gchunk]
            G = len(sub)
            s_arr = np.zeros((G, npad), np.int64)
            m_arr = np.zeros((G, npad), bool)
            geo = np.zeros((5, G), np.int64)   # lo, tcount, x1, x2, x3
            for j, gi in enumerate(sub):
                key, s, a, b = prep[gi]
                s_arr[j, :len(s)] = s
                m_arr[j, :len(s)] = True
                geo[:, j] = (lo_all[gi], tcount[gi], a, b, a + b)
            geo_t = torch.from_numpy(geo).to(dev)
            bt, ns = _mle_scan(tab, filter_size, Tp,
                               torch.from_numpy(s_arr).to(dev),
                               torch.from_numpy(m_arr).to(dev), *geo_t)
            bt = bt.cpu().numpy()
            ns = ns.cpu().numpy()
            for j, gi in enumerate(sub):
                key = prep[gi][0]
                d = max(first, int(bt[j]) - adjust)
                out[key] = (d, int(ns[j]))
    return out


@dataclass
class DistanceEstimate:
    """Edge payload {distance, numPairs, stdDev} (Common/Estimate.h:26)."""
    distance: int
    num_pairs: int
    std_dev: float

    def __str__(self):
        return f"{self.distance},{self.num_pairs},{self.std_dev:.1f}"


def estimate_distances(links: list[PairLink], hist: Histogram,
                       min_pairs: int = 10, min_align: int = 32,
                       min_dist: int | None = None,
                       max_dist: int | None = None,
                       mode: str = "mle", device="cuda",
                       ) -> dict[tuple[str, int, str, int], DistanceEstimate]:
    """Group pair links by oriented contig pair and estimate distances
    (DistanceEst.cpp main loop).  Returns {(u, su, v, sv): estimate}.

    mode: "mle" (window-corrected likelihood, the default), "median" or
    "mean" (population median/mean of the fragment distribution minus
    the sample median/mean span — DistanceEst --median/--mean, used by
    abyss-pe's scaffold stage, bin/abyss-pe:355 scaffold_deopt).

    The MLE of 64 or more groups runs on `device`; fewer take the host
    path, as in the JAX package."""
    pmf = PMF.from_histogram(hist)
    if min_dist is None:
        min_dist = -(len(pmf.probs) - 1)
    if max_dist is None:
        max_dist = len(pmf.probs) - 1

    groups: dict[tuple[str, int, str, int], list] = {}
    for ln in links:
        key = (ln.u_name, ln.u_sense, ln.v_name, ln.v_sense)
        # span without the gap: distance from read1 start to u's end plus
        # read2's end position on v
        span = (ln.u_len - ln.p1) + (ln.p2 + ln.a2)
        groups.setdefault(key, []).append((span, ln.u_len, ln.v_len))

    out = {}
    mle_groups = []
    for key, vals in groups.items():
        if len(vals) < min_pairs:
            continue
        samples = [v[0] for v in vals]
        if mode in ("median", "mean"):
            pop = (pmf.median if mode == "median" else pmf.mean)
            samp = (float(np.median(samples)) if mode == "median"
                    else float(np.mean(samples)))
            d, n = int(round(pop - samp)), len(samples)
            if n < min_pairs:
                continue
            out[key] = DistanceEstimate(
                distance=d, num_pairs=n, std_dev=pmf.sd / math.sqrt(n))
        else:
            mle_groups.append((key, samples, vals[0][1], vals[0][2]))
    if mle_groups:
        if len(mle_groups) < 64:
            # small workloads: the host scan, as the JAX package
            # switches (there, to spare a compile per bucket shape);
            # the switch decides which code computes the estimate
            dn = {key: maximum_likelihood_estimate(
                samples, pmf, l0, l1, first=min_dist, last=max_dist,
                min_align=min_align)
                for key, samples, l0, l1 in mle_groups}
        else:
            dn = estimate_distances_device(mle_groups, pmf,
                                           first=min_dist,
                                           last=max_dist,
                                           min_align=min_align,
                                           device=device)
        for key, (d, n) in dn.items():
            if n < min_pairs:
                continue
            out[key] = DistanceEstimate(
                distance=d, num_pairs=n, std_dev=pmf.sd / math.sqrt(n))
    return out


def write_dist_dot(estimates, lengths: dict[str, int], out, k: int = 0):
    """Write the -3.dist.dot-style distance graph (DotIO + DistanceEst
    edge properties [d= e= n=])."""
    import os
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        f.write("digraph dist {\n")
        if k:
            f.write(f"graph [k={k}]\n")
        for name, L in lengths.items():
            f.write(f'"{name}+" [l={L}]\n"{name}-" [l={L}]\n')
        ss = "+-"
        for (u, su, v, sv), e in estimates.items():
            f.write(f'"{u}{ss[su]}" -> "{v}{ss[sv]}" '
                    f'[d={e.distance} e={e.std_dev:.1f} n={e.num_pairs}]\n')
        f.write("}\n")
    finally:
        if own:
            f.close()
