"""Overlap-save FFT convolution engine (the device hot path).

Replaces the reference's per-thread O(N*M) direct time-domain loop
(/root/reference/FilterCore.h:20-79) with an O(N log B) frequency-domain
engine: rFFT(block) * H -> irFFT, overlap-save with kernel-length history
(SURVEY.md §3.5: ~200x algorithmic advantage at default shapes before any
hardware advantage).

Semantics are exactly the reference's zero-padded "same" convolution
(see :mod:`.oracle`):

    out[i] = sum_{k=0}^{M} h[k] * x[i - Mo2 + k],   x == 0 outside [0, N)

Blocking scheme (derivation in SURVEY.md §7 step 4): with FFT size B and
hop L = B - M, block j reads padded input xp[j*L : j*L + B] where
xp = [Mo2 zeros | x | right-pad zeros]; the circular convolution of the
block with the reversed kernel is alias-free in positions [M, B), which are
precisely out[j*L : j*L + L].

Engines (``make_plan(engine=...)``):
- ``"fft"``: ``jnp.fft.rfft`` / ``irfft`` (cuFFT on the GPU). "high" runs
  in float64 with a complex128 kernel spectrum, inside :func:`x64_scope`
  (JAX's x64 switch is process-wide, so it is scoped to the engine's own
  calls and never set globally); "fast" runs in float32 / complex64.
  Inputs and outputs are float32 either way.
- ``"fourstep"``, ``"pease"``, ``"stockham"``: the framework's own FFTs
  (:mod:`.fft_core`) over float32 pairs ("fast") or double-float pairs
  ("high", :mod:`.df64`), in plain JAX.

Fidelity gates, scale-relative against the float64 oracle: <= 1 LSB at
24-bit for "high", <= 1 LSB at 16-bit for "fast". There is no matrix
product on the device path, so TF32 never applies; a matrix product added
here must pass ``precision=jax.lax.Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import fft_core
from .fft_core import ARITH_DF64, ARITH_F32
from ..utils.jax_setup import configure_jax
from ..utils.options import ENGINES

configure_jax()

FAST = "fast"
HIGH = "high"


def default_engine() -> str:
    """The production engine, the same on every backend.

    ``fft`` passed both gates and ran one headline streaming segment
    (M = 38,400, B = 2^18, 2 x 67.8 M frames) 5.6x faster than
    ``fourstep`` at high precision and 4.2x at fast, on an H100 80GB HBM3
    at a 400 W power limit (0.0128 vs 0.0723 s, 0.0077 vs 0.0325 s)."""
    return "fft"


# Default blocks convolved per device step (plan.conv_chunk): an untuned
# default that bounds the per-step live set.
CONV_CHUNK = 16


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def choose_block_size(num_taps: int, requested: int = 0,
                      min_size: int = 1 << 13, max_size: int = 1 << 21) -> int:
    """FFT size B for kernel length T: smallest power of two >= 4*(T-1),
    clamped to [min_size, max_size] but always > 2*(T-1) so the hop L = B-M
    stays a useful fraction of B — with a 2^18 floor for production-scale
    kernels (M >= 2^13): B = 2^18 at 44.1 and 96 kHz, next_pow2(4M) above
    (2^19 at 192 kHz). The floor is an untuned default. Small kernels
    (M < 2^13, test-scale) keep the min_size rule so CPU tests stay on
    small FFTs."""
    m = num_taps - 1
    if requested:
        b = _next_pow2(requested)
        if b <= m:
            raise ValueError(f"block size {requested} must exceed kernel order {m}")
        return b
    b = max(min_size, _next_pow2(4 * max(m, 1)))
    if m >= (1 << 13):
        b = max(b, 1 << 18)
    while b > max_size and b >= 4 * _next_pow2(m + 1):
        b >>= 1
    return b


@dataclasses.dataclass(frozen=True)
class OverlapSavePlan:
    """Static convolution plan: sizes + frequency-domain kernel.

    ``H`` is the reversed, zero-padded kernel's spectrum in the engine's
    layout and arithmetic: for ``fft`` the natural-order rfft spectrum
    (complex128 for "high", complex64 for "fast"); for the fft_core
    engines the permuted order their constant-geometry FFT produces, as
    C32 ("fast") or CDF64 ("high") pairs, so no reordering happens on
    device.
    """

    num_taps: int          # T = M + 1
    block_size: int        # B (power of two)
    precision: str
    engine: str = "fft"    # resolved value; "auto" resolves in make_plan
    # Blocks convolved per in-jit lax.map step (see CONV_CHUNK). Part of the
    # compiled program, hence of `static` — a bare module global here once
    # silently went stale in the jit cache.
    conv_chunk: int = 16
    H: object = dataclasses.field(default=None, compare=False)

    @property
    def m(self) -> int:
        return self.num_taps - 1

    @property
    def mo2(self) -> int:
        return self.m // 2

    @property
    def hop(self) -> int:
        return self.block_size - self.m

    @property
    def static(self) -> tuple:
        """Hashable static half of the plan (jit static_argnums carrier)."""
        return (self.num_taps, self.block_size, self.precision, self.engine,
                self.conv_chunk)


def x64_scope(plan_static: tuple):
    """Context in which the plan's device calls run: float64 enabled for the
    high-precision ``fft`` engine, unchanged otherwise. Every entry point
    that runs a plan (here and in :mod:`..parallel.sharded_conv`) enters
    it."""
    _, _, precision, engine, _ = plan_static
    if engine == "fft" and precision == HIGH:
        return jax.enable_x64(True)
    return contextlib.nullcontext()


def make_plan(taps: np.ndarray, precision: str = HIGH, block_size: int = 0,
              engine: str = "auto",
              conv_chunk: int = CONV_CHUNK) -> OverlapSavePlan:
    taps = np.asarray(taps, dtype=np.float64)
    t = len(taps)
    if t % 2 != 1:
        raise ValueError("taps must have odd length (type-I linear phase)")
    b = choose_block_size(t, block_size)
    arith = {FAST: ARITH_F32, HIGH: ARITH_DF64}.get(precision)
    if arith is None:
        raise ValueError(f"unknown precision {precision!r} (use 'fast' or 'high')")
    if engine == "auto":
        engine = default_engine()
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} "
                         f"(use 'auto' or one of {', '.join(ENGINES)})")
    hr = np.zeros(b, dtype=np.float64)
    hr[:t] = taps[::-1]
    if engine == "fft":
        plan = OverlapSavePlan(t, b, precision, engine, conv_chunk)
        cdt = np.complex128 if precision == HIGH else np.complex64
        with x64_scope(plan.static):
            H = jnp.asarray(np.fft.rfft(hr).astype(cdt))
        return dataclasses.replace(plan, H=H)
    if engine == "fourstep":
        H64 = fft_core.fourstep_dif_fft_np(hr, *fft_core.fourstep_split(b))
    elif engine == "pease":
        H64 = fft_core.pease_fft_np(hr)       # permuted-order spectrum
    else:
        H64 = np.fft.rfft(hr)                  # natural-order rfft spectrum
    H = jax.tree.map(jnp.asarray, arith.wrap_np(H64))
    return OverlapSavePlan(t, b, precision, engine, conv_chunk, H=H)


# ----------------------------------------------------------------- core math

def _blocks_from_padded(xp: jax.Array, nb: int, hop: int, b: int) -> jax.Array:
    """Overlapped blocks [nb, B] (block j = xp[j*hop : j*hop + B]) from the
    padded 1-D signal, using only reshapes/slices/concat.

    The overlapped view is assembled from k = ceil(B/hop) contiguous
    reshaped copies shifted by one hop each:
    part_k[j] = xp[(j+k)*hop : (j+k+1)*hop], so
    concat(parts, axis=1)[:, :B] == blocks. Each part is a pure reshape of
    a contiguous slice — XLA compiles this to plain copies, with no gather.

    Requires len(xp) >= (nb + k - 1) * hop (callers pad to this).
    """
    k = -(-b // hop)  # ceil
    parts = [
        xp[i * hop : (i + nb) * hop].reshape(nb, hop) for i in range(k)
    ]
    return jnp.concatenate(parts, axis=1)[:, :b] if k > 1 else parts[0][:, :b]


def _fft_conv_blocks(blocks: jax.Array, H, precision: str) -> jax.Array:
    """[nb, B] float32 blocks -> circular convolutions, via jnp.fft."""
    dt = jnp.float64 if precision == HIGH else jnp.float32
    if jax.dtypes.canonicalize_dtype(dt) != dt:
        # Outside x64_scope a float64 cast silently yields float32.
        raise RuntimeError("the high-precision fft engine must run inside "
                           "overlap_save.x64_scope")
    b = blocks.shape[-1]
    y = jnp.fft.irfft(jnp.fft.rfft(blocks.astype(dt), axis=-1) * H, n=b,
                      axis=-1)
    return y.astype(jnp.float32)


def _conv_blocks(blocks: jax.Array, H, precision: str, engine: str) -> jax.Array:
    """[nb(even), B] real blocks -> [nb, B] circular-convolution outputs."""
    if engine == "fft":
        return _fft_conv_blocks(blocks, H, precision)
    arith = ARITH_F32 if precision == FAST else ARITH_DF64
    if engine == "fourstep":
        return fft_core.fourstep_conv_real_blocks(blocks, H, arith)
    if engine == "pease":
        return fft_core.pease_conv_real_blocks(blocks, H, arith)
    return fft_core.rfft_multiply_irfft(blocks, H, arith)


def _filter_blocks(blocks: jax.Array, H, m: int, precision: str,
                   engine: str, chunk: int) -> jax.Array:
    """[nb(even), B] blocks -> [nb, L] valid outputs (FFT . *H . iFFT, slice).

    Large batches are split into ``chunk``-block groups processed by an
    in-jit ``lax.map`` (device-serialized, small live set), with an uneven
    tail handled by one direct call.
    """
    nb = blocks.shape[0]
    nc, rem = divmod(nb, chunk)
    if nc <= 1:
        y = _conv_blocks(blocks, H, precision, engine)
    else:
        head = blocks[: nc * chunk].reshape(nc, chunk, blocks.shape[1])
        yh = jax.lax.map(
            lambda c: _conv_blocks(c, H, precision, engine), head)
        yh = yh.reshape(nc * chunk, blocks.shape[1])
        if rem:
            yt = _conv_blocks(blocks[nc * chunk :], H, precision, engine)
            y = jnp.concatenate([yh, yt], axis=0)
        else:
            y = yh
    return y[..., m:]


def _same_filter_impl(x: jax.Array, plan_static: tuple, H) -> jax.Array:
    """Zero-padded 'same' filtering of [C, N] (N static). Core jit body."""
    t, b, precision, engine, chunk = plan_static
    m, mo2, hop = t - 1, (t - 1) // 2, b - (t - 1)
    c, n = x.shape
    nb = -(-n // hop)  # ceil
    nb += nb & 1  # even: the fft_core engines pair two real blocks per FFT
    # Pad so the reshape-based blocking can take k = ceil(B/hop) shifted
    # contiguous views: len(xp) = (nb + k - 1) * hop >= nb*hop + m.
    k = -(-b // hop)
    pad_right = (nb + k - 1) * hop - mo2 - n
    xp = jnp.pad(x, ((0, 0), (mo2, pad_right)))

    # Channels fold into the block axis BEFORE the conv so the chunked
    # lax.map in _filter_blocks keeps its small per-step live set (a vmap
    # around it would re-batch every chunk by C). Blocks are channel-major,
    # so the [C, nb*L] unfold below is exact; complex pairing across a
    # channel boundary is fine — conv with a real kernel is real-linear
    # per block regardless of which channel a block came from.
    blocks = jax.vmap(lambda xc: _blocks_from_padded(xc, nb, hop, b))(xp)
    yb = _filter_blocks(blocks.reshape(c * nb, b), H, m, precision, engine,
                        chunk)
    return yb.reshape(c, nb * hop)[:, :n]


@functools.partial(jax.jit, static_argnums=(1,))
def _same_filter_jit(x, plan_static, H):
    return _same_filter_impl(x, plan_static, H)


def same_filter(x, plan: OverlapSavePlan) -> jax.Array:
    """Filter [N] or [C, N] float32 with reference 'same' semantics."""
    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    with x64_scope(plan.static):
        y = _same_filter_jit(x, plan.static, plan.H)
    return y[0] if squeeze else y


def extended_filter(xe, plan: OverlapSavePlan, out_len: int) -> jax.Array:
    """Filter with explicit halos: xe is [C, S + M] = [left Mo2 | body S | right Mo2].

    Returns out[0:S] for the body region — the primitive used by host-side
    segmentation and by the sharded time-parallel path (halos replace
    zero-padding except at true signal edges; SURVEY.md §2.3).
    """
    xe = jnp.asarray(xe, dtype=jnp.float32)
    squeeze = xe.ndim == 1
    if squeeze:
        xe = xe[None, :]
    with x64_scope(plan.static):
        y = _same_filter_jit(xe, plan.static, plan.H)
    y = y[:, plan.mo2 : plan.mo2 + out_len]
    return y[0] if squeeze else y


@functools.partial(jax.jit, static_argnums=(1,))
def _same_filter_peak_jit(x, plan_static, H):
    y = _same_filter_impl(x, plan_static, H)
    peak = jnp.max(jnp.abs(y)) if y.size else jnp.float32(0)
    return y, peak


def same_filter_peak(x, plan: OverlapSavePlan):
    """:func:`same_filter` that also returns the output's |max| peak,
    reduced on device — the single-segment analog of
    :func:`extended_filter_peak` (edge zero-padding stays ON DEVICE, no
    host-side padded staging copy)."""
    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    with x64_scope(plan.static):
        y, peak = _same_filter_peak_jit(x, plan.static, plan.H)
    return (y[0] if squeeze else y), peak


@functools.partial(jax.jit, static_argnums=(1, 3))
def _extended_filter_peak_jit(xe, plan_static, H, out_len):
    t = plan_static[0]
    mo2 = (t - 1) // 2
    y = _same_filter_impl(xe, plan_static, H)
    y = jax.lax.slice_in_dim(y, mo2, mo2 + out_len, axis=1)
    peak = jnp.max(jnp.abs(y)) if y.size else jnp.float32(0)
    return y, peak


def extended_filter_peak(xe, plan: OverlapSavePlan, out_len: int):
    """:func:`extended_filter` that also returns the segment's |max| peak,
    reduced ON DEVICE (fused into the same program) — the streaming
    pipeline's building block for the reference's maxMag reduction
    (/root/reference/ProcessFile.cp:92-97) without a second full host pass
    over the output."""
    xe = jnp.asarray(xe, dtype=jnp.float32)
    squeeze = xe.ndim == 1
    if squeeze:
        xe = xe[None, :]
    with x64_scope(plan.static):
        y, peak = _extended_filter_peak_jit(xe, plan.static, plan.H,
                                            out_len)
    return (y[0] if squeeze else y), peak
