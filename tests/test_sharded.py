"""Sequence-parallel (sharded) convolution tests on a virtual 8-device CPU
mesh (SURVEY.md §4.3: distributed tests without a pod).

Core assertion: time-sharded result with ppermute halo exchange == the
single-device engine result (which itself matches the f64 oracle), for
meshes that exercise 1, 4, and 8 time shards and a (2, 4) data x time mesh.
"""

import numpy as np
import pytest

import jax

from lowcut.ops import kernel_design as kd
from lowcut.ops import oracle
from lowcut.ops import overlap_save as osv
from lowcut.parallel import make_mesh, sharded_filter, sharded_filter_padded

from util import high_tol_lsb24



@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


def make_case(n, channels=2, bw=0.02, fc=0.05, seed=0):
    ws = kd.WindowedSinc(fc, bw).make_low_cut()  # T=201
    rng = np.random.default_rng(seed)
    x = (0.4 * rng.uniform(-1, 1, (channels, n))).astype(np.float32)  # keep filtered peak < 1 (no auto-normalize)
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024)
    return x, ws, plan


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 4), (1, 8), (2, 4)])
def test_sharded_matches_single_device(mesh_shape):
    x, ws, plan = make_case(n=8000)
    mesh = make_mesh(mesh_shape)
    y, peak = sharded_filter(x, plan, mesh)
    ref = np.asarray(osv.same_filter(x, plan))
    # sharded vs serial: same math, different block alignment per shard ->
    # equality at the quantization level.
    assert oracle.max_lsb_error(np.asarray(y), ref, bits=24) <= 2 * high_tol_lsb24()
    assert np.isclose(float(peak), np.max(np.abs(ref)), rtol=1e-5)


def test_sharded_matches_oracle_exact_semantics():
    """Halo exchange must reproduce zero-pad edges only at global edges."""
    x, ws, plan = make_case(n=4000, channels=1)
    mesh = make_mesh((1, 8))  # shard length 500 << kernel span tests halos hard
    y, _ = sharded_filter(x, plan, mesh)
    ref = oracle.direct_filter(x[0], ws.taps)
    assert oracle.max_lsb_error(np.asarray(y)[0], ref, bits=24) <= 2 * high_tol_lsb24()


def test_shard_smaller_than_halo_rejected_or_correct():
    """Shards shorter than Mo2: ppermute only reaches direct neighbors, so
    this would be silently wrong — the API must refuse or be correct."""
    x, ws, plan = make_case(n=160, channels=1)  # shard len 20 < Mo2=100
    mesh = make_mesh((1, 8))
    try:
        y, _ = sharded_filter(x, plan, mesh)
    except ValueError:
        return  # refusing is acceptable
    ref = oracle.direct_filter(x[0], ws.taps)
    assert oracle.max_lsb_error(np.asarray(y)[0], ref, bits=24) <= 2 * high_tol_lsb24()


def test_sharded_padded_arbitrary_shapes():
    x, ws, plan = make_case(n=7777, channels=3)
    mesh = make_mesh((2, 4))
    y, _ = sharded_filter_padded(x, plan, mesh)
    assert np.asarray(y).shape == (3, 7777)
    ref = np.asarray(osv.same_filter(x, plan))
    assert oracle.max_lsb_error(np.asarray(y), ref, bits=24) <= 2 * high_tol_lsb24()


def test_sharded_normalize_fused():
    x, ws, plan = make_case(n=8000, seed=5)
    x *= 0.1
    mesh = make_mesh((1, 8))
    y, peak = sharded_filter(x, plan, mesh, normalize=True)
    y = np.asarray(y)
    assert np.isclose(np.max(np.abs(y)), 1.0, atol=1e-5)
    # common factor: ratios preserved vs unnormalized
    y0, _ = sharded_filter(x, plan, mesh, normalize=False)
    ratio = np.asarray(y0) / np.maximum(np.abs(y), 1e-12) / np.sign(y + (y == 0))
    # just check the scale is uniform where signal is significant
    mask = np.abs(y) > 1e-2
    scales = np.asarray(y0)[mask] / y[mask]
    assert np.allclose(scales, scales.flat[0], rtol=1e-4)


def test_sharded_auto_normalize_on_clip():
    """Reference clip rule (ProcessFile.cp:98-101): even without -n, output
    is scaled by one common 1/peak factor when the filtered peak clips.
    This is the case the round-2 dryrun artifact mis-asserted (it compared
    the auto-scaled output against the raw oracle)."""
    x, ws, plan = make_case(n=8000, seed=3)
    x = (x * 4.0).astype(np.float32)  # drive filtered peak over 1.0
    mesh = make_mesh((2, 4))
    y, peak = sharded_filter(x, plan, mesh, normalize=False)
    ref = np.asarray(osv.same_filter(x, plan))
    ref_peak = float(np.max(np.abs(ref)))
    assert ref_peak > 1.0  # the case actually exercises the clip rule
    assert np.isclose(float(peak), ref_peak, rtol=1e-5)
    assert oracle.max_lsb_error(np.asarray(y), ref / ref_peak,
                                bits=24) <= 4 * high_tol_lsb24()


def test_sharded_indivisible_raises():
    x, ws, plan = make_case(n=8001)
    mesh = make_mesh((1, 8))
    with pytest.raises(ValueError):
        sharded_filter(x, plan, mesh)


def test_sharded_edge_halos_chain_segments():
    """Edge halos replace zero padding: filtering a middle segment with its
    true neighbor halos must equal the corresponding slice of the whole."""
    x, ws, plan = make_case(n=6000, channels=2)
    mesh = make_mesh((1, 8))
    ref = np.asarray(osv.same_filter(x, plan))
    s, seg = 2000, 2000
    mo2 = plan.mo2
    y_seg, _ = sharded_filter(
        x[:, s : s + seg], plan, mesh,
        edge_left=x[:, s - mo2 : s], edge_right=x[:, s + seg : s + seg + mo2])
    assert oracle.max_lsb_error(np.asarray(y_seg), ref[:, s : s + seg],
                                bits=24) <= 2 * high_tol_lsb24()


def test_sharded_streamed_matches_unsharded_and_reports_progress():
    from lowcut.pipeline.stream import sharded_filter_streamed

    x, ws, plan = make_case(n=9000, channels=3, seed=11)
    mesh = make_mesh((2, 4))
    ticks = []
    y, peak = sharded_filter_streamed(x, plan, mesh, segment_len=2048,
                                      progress_cb=ticks.append)
    ref = np.asarray(osv.same_filter(x, plan))
    assert y.shape == ref.shape
    assert oracle.max_lsb_error(y, ref, bits=24) <= 2 * high_tol_lsb24()
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-5)
    # The bar must actually move: several segment-sized increments summing
    # to the total (reference redraws continuously, ProgressBar.h:34-47).
    assert len(ticks) >= 3
    assert sum(ticks) == x.size


def test_sharded_streamed_no_per_segment_scaling():
    """A clipping segment must NOT be scaled alone: one global factor only
    (ProcessFile.cp:92-101)."""
    from lowcut.pipeline.stream import sharded_filter_streamed

    x, ws, plan = make_case(n=6000, channels=1, seed=2)
    x = (x * 4.0).astype(np.float32)  # drive the filtered peak over 1.0
    mesh = make_mesh((1, 8))
    y, peak = sharded_filter_streamed(x, plan, mesh, segment_len=1500)
    ref = np.asarray(osv.same_filter(x, plan))
    assert peak > 1.0  # the case is actually exercising the clip rule
    assert oracle.max_lsb_error(y, ref, bits=24) <= 4 * high_tol_lsb24()


# ------------------------------------------- default engine, both precisions

PRECISIONS = [(osv.HIGH, 24), (osv.FAST, 16)]


def _random_taps_case(num_taps):
    """Random odd-length taps + a 2-channel signal."""
    rng = np.random.default_rng(0)
    taps = rng.standard_normal(num_taps) * 0.05
    taps[num_taps // 2] += 1.0
    x = (0.4 * rng.uniform(-1, 1, (2, 6144))).astype(np.float32)
    return taps, x


@pytest.mark.parametrize("precision,bits", PRECISIONS)
@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4)])
@pytest.mark.parametrize("num_taps,block", [(193, 1024), (201, 1024),
                                            (201, 256)])
def test_sharded_default_engine_matches_oracle(mesh_shape, num_taps, block,
                                               precision, bits):
    """The default engine under shard_map (ppermute halos) matches the
    float64 oracle within the precision's gate, for hops much shorter and
    much longer than the shard."""
    taps, x = _random_taps_case(num_taps)
    plan = osv.make_plan(taps, precision=precision, block_size=block)
    mesh = make_mesh(mesh_shape)
    y, peak = sharded_filter(x, plan, mesh)
    y = np.asarray(y)
    ref = np.stack([oracle.direct_filter(x[c], taps) for c in range(2)])
    assert oracle.max_lsb_error(y, ref, bits=bits) <= 1.0
    assert np.isclose(float(peak), np.max(np.abs(ref)), rtol=1e-5)


@pytest.mark.parametrize("precision,bits", PRECISIONS)
def test_sharded_default_engine_edge_halos_and_normalize(precision, bits):
    """Segment chaining (host-fed edge halos) and the fused auto-normalize
    with the default engine in the shard_map body."""
    taps, x = _random_taps_case(193)
    plan = osv.make_plan(taps, precision=precision, block_size=1024)
    mesh = make_mesh((1, 4))
    ref = np.stack([oracle.direct_filter(x[c], taps) for c in range(2)])
    s, seg = 2048, 2048
    mo2 = plan.mo2
    y_seg, _ = sharded_filter(
        x[:, s : s + seg], plan, mesh,
        edge_left=x[:, s - mo2 : s], edge_right=x[:, s + seg : s + seg + mo2])
    assert oracle.max_lsb_error(np.asarray(y_seg), ref[:, s : s + seg],
                                bits=bits) <= 1.0
    yn, _ = sharded_filter(x, plan, mesh, normalize=True)
    assert np.isclose(np.max(np.abs(np.asarray(yn))), 1.0, atol=1e-5)


@pytest.mark.parametrize("precision,bits", PRECISIONS)
def test_sharded_streamed_default_engine(precision, bits):
    """The whole multi-device path: host segment streaming (edge-halo
    chaining) over shard_map (ppermute halos) running the default engine
    — what `--mesh DxT` does for a long file."""
    from lowcut.pipeline.stream import sharded_filter_streamed

    taps, x = _random_taps_case(193)
    plan = osv.make_plan(taps, precision=precision, block_size=1024)
    mesh = make_mesh((1, 4))
    y, peak = sharded_filter_streamed(x, plan, mesh, segment_len=2048)
    ref = np.stack([oracle.direct_filter(x[c], taps) for c in range(2)])
    assert oracle.max_lsb_error(y, ref, bits=bits) <= 1.0
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-5)
