"""Sequence-parallel overlap-save convolution over a device mesh.

The device replacement for the reference's range-split threading
(/root/reference/ProcessFile.cp:60-83): the time axis of every channel is
sharded across the mesh's ``"time"`` axis; each device filters its local
segment after receiving kernel-length halos from its neighbors via
``jax.lax.ppermute`` (SURVEY.md §2.3 "halo/boundary handling").

Why this is exact: device d owns output range [d*S, (d+1)*S) and
out[i] needs x[i - Mo2 .. i + Mo2] (FilterCore.h's kernel span). The left
neighbor sends its last Mo2 samples, the right neighbor its first Mo2;
``ppermute`` delivers **zeros** to devices with no sending partner — which
is exactly the reference's zero-padding at the true signal edges
(FilterCore.h:57-76), so no special-casing of boundary shards is needed.

Peak normalization is the sharded analog of ProcessFile.cp:92-101: local
|max| then ``lax.pmax`` over both mesh axes, and a fused conditional scale
(auto-normalize when the filtered peak clips, or always with -n).

Channels ride the ``"data"`` mesh axis (the reference processes channels
sequentially — SURVEY.md §2.3 calls out this free parallelism it leaves on
the table).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import overlap_save as osv
from .mesh import DATA_AXIS, TIME_AXIS


def _halo_exchange(x_local: jax.Array, mo2: int, axis_name: str,
                   edge_left: jax.Array | None = None,
                   edge_right: jax.Array | None = None) -> jax.Array:
    """[C, S] -> [C, S + 2*Mo2] with neighbor halos.

    Mesh-edge shards receive ``edge_left`` / ``edge_right`` ([C, Mo2],
    replicated) when given, else zeros — zeros reproduce the reference's
    zero-padding at true signal edges (FilterCore.h:57-76); explicit edges
    let a host segment loop chain segments exactly (pipeline streaming).
    """
    n_shards = jax.lax.axis_size(axis_name)
    if n_shards == 1 or mo2 == 0:
        zero = jnp.zeros((x_local.shape[0], mo2), x_local.dtype)
        left = zero if edge_left is None else edge_left
        right = zero if edge_right is None else edge_right
        return jnp.concatenate([left, x_local, right], axis=1)
    # Send my tail to my right neighbor => I receive my LEFT halo.
    right_perm = [(i, i + 1) for i in range(n_shards - 1)]
    left_halo = jax.lax.ppermute(x_local[:, -mo2:], axis_name, right_perm)
    # Send my head to my left neighbor => I receive my RIGHT halo.
    left_perm = [(i, i - 1) for i in range(1, n_shards)]
    right_halo = jax.lax.ppermute(x_local[:, :mo2], axis_name, left_perm)
    idx = jax.lax.axis_index(axis_name)
    if edge_left is not None:
        left_halo = jnp.where(idx == 0, edge_left, left_halo)
    if edge_right is not None:
        right_halo = jnp.where(idx == n_shards - 1, edge_right, right_halo)
    return jnp.concatenate([left_halo, x_local, right_halo], axis=1)


def _local_filter(x_local: jax.Array, H, plan_static: tuple,
                  edge_left=None, edge_right=None) -> jax.Array:
    """Per-device body: halo exchange + overlap-save on the extended segment."""
    t = plan_static[0]
    mo2 = (t - 1) // 2
    xe = _halo_exchange(x_local, mo2, TIME_AXIS, edge_left, edge_right)
    y = osv._same_filter_impl(xe, plan_static, H)
    return y[:, mo2 : mo2 + x_local.shape[1]]


def _local_peak(y_local: jax.Array) -> jax.Array:
    peak = jnp.max(jnp.abs(y_local)) if y_local.size else jnp.float32(0)
    peak = jax.lax.pmax(peak, TIME_AXIS)
    return jax.lax.pmax(peak, DATA_AXIS)


@functools.partial(jax.jit, static_argnums=(1, 4, 5, 6))
def _sharded_filter_jit(x, plan_static, H, normalize_flag, mesh,
                        with_edges=False, auto_scale=True,
                        edge_left=None, edge_right=None):
    spec_x = P(DATA_AXIS, TIME_AXIS)

    def body(x_local, H_local, norm_flag, *edges):
        el, er = edges if with_edges else (None, None)
        y = _local_filter(x_local, H_local, plan_static, el, er)
        peak = _local_peak(y)
        if not auto_scale:
            # Segment-streaming mode: the caller owns the one global
            # scale decision (a per-segment scale would break the
            # reference's single common factor, ProcessFile.cp:92-101).
            return y, peak
        # Reference rule (ProcessFile.cp:98-101): scale iff clip or -n.
        do_scale = jnp.logical_or(peak > 1.0, norm_flag)
        safe_peak = jnp.where(peak > 0.0, peak, 1.0)
        scale = jnp.where(do_scale, 1.0 / safe_peak, 1.0).astype(jnp.float32)
        return y * scale, peak

    # Edge halos are tiny ([C, Mo2]) and needed whole by the edge shards:
    # replicate them (sharded only over channels on the data axis).
    edge_spec = P(DATA_AXIS, None)
    in_specs = (spec_x, P(), P()) + ((edge_spec, edge_spec) if with_edges
                                     else ())
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(spec_x, P()),
    )
    args = (x, H, normalize_flag)
    if with_edges:
        args += (edge_left, edge_right)
    return fn(*args)


def sharded_filter(
    x,
    plan: osv.OverlapSavePlan,
    mesh: Mesh,
    normalize: bool = False,
    edge_left=None,
    edge_right=None,
    auto_scale: bool = True,
):
    """Filter [C, N] float32 across the mesh; returns (y [C, N], peak scalar).

    C must be divisible by the "data" axis size and N by the "time" axis
    size; use :func:`pad_for_mesh` / slicing for arbitrary shapes (the CLI
    pipeline does). The peak returned is the pre-scale global maximum, for
    parity with the reference's maxMag (ProcessFile.cp:92-97).

    ``edge_left`` / ``edge_right`` ([C, Mo2] float32) replace the zero
    padding at the mesh edges — the segment-streaming analog of
    :func:`..ops.overlap_save.extended_filter`'s halos. Leave None for true
    signal edges (reference zero-pad semantics).
    """
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2:
        raise ValueError("sharded_filter expects [C, N]")
    d, t = mesh.devices.shape
    c, n = x.shape
    if c % d or n % t:
        raise ValueError(
            f"shape {x.shape} not divisible by mesh {mesh.devices.shape}; "
            "pad first (see pad_for_mesh)")
    if t > 1 and n // t < plan.mo2:
        # Halos come from direct neighbors only; a shard shorter than Mo2
        # cannot supply its neighbor's full kernel span.
        raise ValueError(
            f"time shard length {n // t} is shorter than the half-kernel "
            f"Mo2={plan.mo2}; use fewer time shards for this signal")
    flag = jnp.asarray(normalize)
    with_edges = edge_left is not None or edge_right is not None
    edges = ()
    if with_edges:
        zero = jnp.zeros((c, plan.mo2), jnp.float32)
        edges = tuple(zero if e is None else jnp.asarray(e, jnp.float32)
                      for e in (edge_left, edge_right))
    with osv.x64_scope(plan.static):
        return _sharded_filter_jit(x, plan.static, plan.H, flag, mesh,
                                   with_edges, auto_scale, *edges)


def pad_for_mesh(x, mesh: Mesh):
    """Zero-pad [C, N] so both axes divide the mesh; returns (xp, (C, N)).

    Zero padding is semantically safe: trailing zeros only influence the
    last Mo2 outputs of the padded region, which are sliced away — and a
    zero tail is exactly the reference's epilogue zero-padding.
    """
    d, t = mesh.devices.shape
    c, n = x.shape
    cp = -(-c // d) * d
    np_ = -(-n // t) * t
    if cp == c and np_ == n:
        return x, (c, n)
    out = jnp.zeros((cp, np_), jnp.float32)
    return out.at[:c, :n].set(x), (c, n)


def sharded_filter_padded(x, plan, mesh, normalize=False):
    """`sharded_filter` for arbitrary [C, N]: pad, filter, slice back.

    The trailing zero-pad is semantically the reference's epilogue
    zero-padding, so outputs for the real region are exact. The normalize
    peak is computed (inside the fused kernel) over the padded output,
    whose pad-region tail ring is bounded by the kernel's stopband leakage
    of the true tail — borderline auto-normalize triggering can differ from
    the serial path by that epsilon; the bit-parity path for files is the
    pipeline's unsharded engine.
    """
    xp, (c, n) = pad_for_mesh(jnp.asarray(x, jnp.float32), mesh)
    y, peak = sharded_filter(xp, plan, mesh, normalize=normalize)
    return y[:c, :n], peak
