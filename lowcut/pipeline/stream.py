"""Host <-> device streaming driver for long signals.

The reference fans the time axis of each channel out across host threads
(/root/reference/ProcessFile.cp:60-83). Here the time axis is cut into
fixed-size segments streamed through the device: every segment is filtered
with kernel-length halos taken from its neighbors in host memory
(:func:`..ops.overlap_save.extended_filter`), so segment boundaries are
exact and only true signal edges are zero-padded — the same 3-phase
semantics as FilterCore.h:57-76.

Fixed segment shapes keep a single compiled executable; JAX's async
dispatch overlaps host slicing of segment k+1 with device compute of
segment k (the device analog of the reference's thread pool staying
busy).
"""

from __future__ import annotations

import numpy as np

from ..ops import overlap_save as osv


def default_segment_len(plan: osv.OverlapSavePlan, target: int = 1 << 26,
                        channels: int = 2) -> int:
    """Segment body length: a multiple of the hop near ``target`` samples,
    aligned so the extended segment blocks into an exact multiple of the
    plan's conv_chunk (no leftover-tail conv graph: a k-hop body plus
    halos yields round_even(k+1) overlap-save blocks)."""
    # The target (an untuned default) is PER CHANNEL PAIR: the device
    # working set (per-channel f32 in/out plus the FFT intermediates of
    # one conv_chunk) scales linearly with channels, so the target is
    # divided by channels/2 to hold the TOTAL device+host budget constant
    # for high-channel-count files (a 16-ch file gets 1/8 the per-channel
    # segment, same total samples per call as the stereo headline). The
    # divisor is non-truncating (2*target/channels) so ODD channel counts
    # hold the same total budget: 3 ch gets 2/3 of the stereo per-channel
    # segment, not the full one.
    per_ch = max(1 << 22, 2 * target // max(2, channels))
    k = max(1, per_ch // plan.hop)
    ch = plan.conv_chunk
    nb = (k + 2) & ~1  # round_even(k + 1)
    k += -nb % ch  # lift so round_even(k+1) is a conv_chunk multiple
    return k * plan.hop


def filter_array_streamed(
    x: np.ndarray,
    plan: osv.OverlapSavePlan,
    segment_len: int = 0,
    progress_cb=None,
) -> tuple[np.ndarray, float]:
    """Filter planar [C, N] float32 through the device in segments.

    Returns ``(y [C, N] float32, peak)``: identical filtering semantics to
    :func:`..ops.overlap_save.same_filter` (zero-padded 'same'), plus the
    global |max| of the output — reduced ON DEVICE per segment (fused into
    the filter program) so the caller's normalize decision
    (/root/reference/ProcessFile.cp:92-101) costs no extra host pass.
    ``progress_cb(num_samples)`` is invoked per finished segment with
    C * segment frames processed.

    Host residency is ~2x the payload (input + output): each segment's
    extended slice [s - Mo2, e + Mo2) is assembled into its own small
    staging buffer with zeros only at the true signal edges — there is NO
    full-length padded copy of the input (a third full-payload array at
    1-hour scale, dropped in round 4).
    """
    if x.ndim == 1:
        y, peak = filter_array_streamed(x[None, :], plan, segment_len,
                                        progress_cb)
        return y[0], peak
    c, n = x.shape
    if n == 0:
        return x.astype(np.float32), 0.0
    seg = segment_len or default_segment_len(plan, channels=c)
    if n <= seg:
        # Single segment: edge zero-padding stays on device (no host
        # staging copy at all for the whole-file-fits case).
        y, peak = osv.same_filter_peak(x, plan)
        y = np.asarray(y)
        if progress_cb:
            progress_cb(c * n)
        return y, float(peak)

    mo2 = plan.mo2
    num_segments = -(-n // seg)
    out = np.empty((c, n), dtype=np.float32)
    peak = 0.0
    pending = []  # (device_y, device_peak, start, end) — drained lazily
    for j in range(num_segments):
        s = j * seg
        e = min(n, s + seg)
        # [C, seg + M] staging buffer: body + halos, zero-padded only where
        # the slice leaves [0, N) (true signal edges / last-segment tail).
        xe = _edge_slice(x, s - mo2, s + seg + mo2)
        yj, pj = osv.extended_filter_peak(xe, plan, seg)  # async dispatch
        pending.append((yj, pj, s, e))
        if len(pending) >= 2:  # keep one segment in flight
            peak = max(peak, _drain(pending.pop(0), out, c, progress_cb))
    while pending:
        peak = max(peak, _drain(pending.pop(0), out, c, progress_cb))
    return out, peak


def _edge_slice(x: np.ndarray, g0: int, g1: int) -> np.ndarray:
    """x[:, g0:g1] with zeros outside [0, N) — one segment-sized buffer."""
    c, n = x.shape
    s0, s1 = max(0, g0), min(n, g1)
    if s0 == g0 and s1 == g1:
        return x[:, g0:g1]  # interior segment: plain view, no copy at all
    buf = np.zeros((c, g1 - g0), dtype=x.dtype)
    buf[:, s0 - g0 : s1 - g0] = x[:, s0:s1]
    return buf


def _drain(item, out, c, progress_cb):
    yj, pj, s, e = item
    if e - s < np.shape(yj)[1]:
        # Final partial segment: the device peak covered pad-tail columns
        # too (the filter ring of the true tail); recompute on the valid
        # slice — one segment, not the whole output.
        seg_y = np.asarray(yj)[:, : e - s]
        out[:, s:e] = seg_y
        peak = float(np.max(np.abs(seg_y))) if seg_y.size else 0.0
    else:
        out[:, s:e] = np.asarray(yj)
        peak = float(pj)
    if progress_cb:
        progress_cb(c * (e - s))
    return peak


def sharded_filter_streamed(
    x: np.ndarray,
    plan: osv.OverlapSavePlan,
    mesh,
    segment_len: int = 0,
    progress_cb=None,
) -> tuple[np.ndarray, float]:
    """Mesh-sharded analog of :func:`filter_array_streamed`.

    Cuts [C, N] into fixed segments, filters each across the mesh
    (ppermute halos between shards; host-fed edge halos chain the
    segments), and reports progress per segment so the bar moves like the
    reference's (ProgressBar.h:34-47) instead of jumping 0 -> 100%.

    Returns (y [C, N] float32, global pre-scale peak). Normalization is the
    CALLER's single common scale (ProcessFile.cp:92-101) — no per-segment
    scaling ever happens (auto_scale=False on device).
    """
    from ..parallel.sharded_conv import sharded_filter

    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        y, peak = sharded_filter_streamed(x[None, :], plan, mesh,
                                          segment_len, progress_cb)
        return y[0], peak
    c, n = x.shape
    if n == 0:
        return x, 0.0
    d, t = mesh.devices.shape
    # Channels pad once to the data axis.
    cp = -(-c // d) * d
    seg = sharded_segment_len(plan, t, c, segment_len)
    mo2 = plan.mo2

    num_segments = -(-n // seg)
    if cp != c:
        # Channel pad to the data axis (tiny for realistic meshes); the
        # TIME axis is never fully padded — segments assemble their own
        # edge-padded staging buffers (no third full-payload copy).
        xpad = np.zeros((cp, n), np.float32)
        xpad[:c] = x
        x_in = xpad
    else:
        x_in = x

    out = np.empty((c, n), dtype=np.float32)
    peak = 0.0
    pending = []
    for j in range(num_segments):
        s = j * seg
        e = min(n, s + seg)
        body = _edge_slice(x_in, s, s + seg)
        left = _edge_slice(x_in, s - mo2, s)
        right = _edge_slice(x_in, s + seg, s + seg + mo2)
        yj, _ = sharded_filter(body, plan, mesh, normalize=False,
                               edge_left=left, edge_right=right,
                               auto_scale=False)
        pending.append((yj, s, e))
        if len(pending) >= 2:
            peak = max(peak, _drain_sharded(pending.pop(0), out, c,
                                            progress_cb))
    while pending:
        peak = max(peak, _drain_sharded(pending.pop(0), out, c, progress_cb))
    return out, peak


def sharded_segment_len(plan: osv.OverlapSavePlan, time_shards: int,
                        channels: int, segment_len: int = 0) -> int:
    """Segment length of :func:`sharded_filter_streamed`: the requested (or
    default) length lifted to a multiple of time_shards * hop, for clean
    overlap-save blocking on every shard, and long enough that each shard
    covers the Mo2 halo. Shard seams sit at multiples of
    ``segment / time_shards``."""
    t, hop = time_shards, plan.hop
    seg = segment_len or default_segment_len(plan, channels=channels)
    seg = max(1, -(-seg // (t * hop))) * t * hop
    if t > 1 and seg // t < plan.mo2:
        seg = -(-plan.mo2 * t // (t * hop)) * t * hop
    return seg


def _drain_sharded(item, out, c, progress_cb):
    yj, s, e = item
    seg_y = np.asarray(yj)[:c, : e - s]
    out[:, s:e] = seg_y
    if progress_cb:
        progress_cb(c * (e - s))
    # Peak over the REAL region only (pad rows/samples excluded), matching
    # the unsharded path's host-side max (ProcessFile.cp:92-97).
    return float(np.max(np.abs(seg_y))) if seg_y.size else 0.0
