"""End-to-end pipeline tests: file in -> filtered file out (SURVEY.md §4).

Golden-model check: CLI-pipeline output samples == oracle(direct f64 conv)
within quantization bounds; metadata chunks preserved byte-exactly;
auto-normalize-on-clip semantics.
"""

import numpy as np
import pytest

from lowcut import audio
from lowcut.audio import Encoding
from lowcut.audio.chunks import Chunk
from lowcut.audio.synth import create_audio_file
from lowcut.ops import kernel_design as kd
from lowcut.ops import oracle
from lowcut.pipeline import filter_array_streamed, process_file
from lowcut.ops import overlap_save as osv
from lowcut.utils.options import FilterOptions

from util import high_tol_lsb24

FS = 8000.0  # low rate keeps kernels short (fast tests)
OPTS = dict(freq=100.0, slope=200.0, precision="high", block_size=1024)


def make_input(tmp_path, name="in.wav", channels=2, frames=6000,
               encoding=Encoding.PCM_24, scale=0.5, extra=None, fs=FS):
    rng = np.random.default_rng(42)
    x = rng.uniform(-scale, scale, (channels, frames)).astype(np.float32)
    p = tmp_path / name
    create_audio_file(p, x, fs, encoding=encoding, extra_chunks=extra or [])
    return p, x


def test_streamed_equals_whole_array():
    ws = kd.WindowedSinc(0.02, 0.025).make_low_cut()
    plan = osv.make_plan(ws.taps, precision="high", block_size=1024)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 20_000)).astype(np.float32)
    whole = np.asarray(osv.same_filter(x, plan))
    seg, peak = filter_array_streamed(x, plan, segment_len=plan.hop * 3)
    assert oracle.max_lsb_error(seg, whole, bits=24) <= 2 * high_tol_lsb24()
    # Device-fused peak must equal the host max over the real region.
    assert np.isclose(peak, np.max(np.abs(whole)), rtol=1e-6)


def test_process_file_matches_oracle(tmp_path):
    p, x = make_input(tmp_path)
    out = tmp_path / "out.wav"
    opts = FilterOptions(**OPTS)
    metrics = process_file(p, out, opts, show_progress=False)
    assert metrics["frames"] == 6000 and metrics["channels"] == 2

    result = audio.read_audio(out)
    # Oracle on the decoded (quantized) input, like the reference pipeline.
    data_in = audio.read_audio(p)
    taps = kd.highpass_taps(opts.freq / FS, kd.kernel_length(opts.slope / FS))
    for c in range(2):
        ref = oracle.direct_filter(data_in.samples[c], taps)
        # engine error + 24-bit output quantization (0.5 LSB)
        err = oracle.max_lsb_error(result.samples[c], ref, bits=24)
        assert err <= high_tol_lsb24() + 0.5


def test_process_file_preserves_metadata(tmp_path):
    meta = Chunk(b"bext", b"broadcast wav metadata blob\x00\x01")
    odd = Chunk(b"JUNK", b"xyz")  # odd-sized
    p, _ = make_input(tmp_path, extra=[meta, odd])
    out = tmp_path / "out.wav"
    process_file(p, out, FilterOptions(**OPTS), show_progress=False)
    cin = audio.read_audio(p).container
    cout = audio.read_audio(out).container
    assert [c.ckid for c in cout.chunks] == [c.ckid for c in cin.chunks]
    for a, b in zip(cin.chunks, cout.chunks):
        if a.ckid != b"data":
            assert a.data == b.data  # byte-exact (README.md:9 parity)


def test_process_file_aiff(tmp_path):
    p, x = make_input(tmp_path, name="in.aif", encoding=Encoding.PCM_16)
    out = tmp_path / "out.aif"
    process_file(p, out, FilterOptions(**OPTS), show_progress=False)
    result = audio.read_audio(out)
    assert result.kind == "aiff"
    assert result.num_frames == 6000
    data_in = audio.read_audio(p)
    taps = kd.highpass_taps(100.0 / FS, kd.kernel_length(200.0 / FS))
    ref = oracle.direct_filter(data_in.samples[0], taps)
    assert oracle.max_lsb_error(result.samples[0], ref, bits=16) <= 1.0


def test_auto_normalize_on_clip(tmp_path):
    """Filtered peak > 1.0 triggers normalize even without -n
    (ProcessFile.cp:98-101)."""
    # Full-scale low-frequency square-ish signal overshoots after high-pass.
    frames = 4000
    t = np.arange(frames) / FS
    x = np.sign(np.sin(2 * np.pi * 300.0 * t)).astype(np.float32)[None, :] * 0.999
    p = tmp_path / "sq.wav"
    create_audio_file(p, x, FS, encoding=Encoding.PCM_24)
    out = tmp_path / "sq_out.wav"
    m = process_file(p, out, FilterOptions(**OPTS), show_progress=False)
    result = audio.read_audio(out)
    peak = np.max(np.abs(result.samples))
    if m["peak"] > 1.0:  # overshoot occurred -> must have been normalized
        assert peak <= 1.0
    assert peak <= 1.0  # never clipped output in any case


def test_deterministic_output_bytes(tmp_path):
    """SURVEY.md §5 (race detection): XLA's functional model replaces the
    reference's thread-safety-by-construction; what we assert instead is
    determinism — the same input produces byte-identical output files
    across independent runs."""
    meta = Chunk(b"bext", b"stamp")
    p, _ = make_input(tmp_path, extra=[meta])
    outs = []
    for i in range(2):
        out = tmp_path / f"det{i}.wav"
        process_file(p, out, FilterOptions(**OPTS), show_progress=False)
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_explicit_normalize(tmp_path):
    p, _ = make_input(tmp_path, scale=0.1)
    out = tmp_path / "n.wav"
    process_file(p, out, FilterOptions(normalize=True, **OPTS), show_progress=False)
    result = audio.read_audio(out)
    assert np.isclose(np.max(np.abs(result.samples)), 1.0, atol=2 ** -20)


# ---------------------------------------------------- auto precision policy

def test_resolve_precision_policy():
    """"auto" resolves by OUTPUT encoding: f32 engine only where its error
    is below 1 LSB at that depth (<= 16-bit PCM); explicit values win."""
    from lowcut.utils.options import resolve_precision

    assert resolve_precision("auto", Encoding.PCM_16) == "fast"
    assert resolve_precision("auto", Encoding.PCM_U8) == "fast"
    assert resolve_precision("auto", Encoding.PCM_S8) == "fast"
    assert resolve_precision("auto", Encoding.PCM_24) == "high"
    assert resolve_precision("auto", Encoding.PCM_32) == "high"
    assert resolve_precision("auto", Encoding.FLOAT_32) == "high"
    assert resolve_precision("high", Encoding.PCM_16) == "high"
    assert resolve_precision("fast", Encoding.PCM_24) == "fast"


def _auto_opts():
    o = dict(OPTS)
    o["precision"] = "auto"
    return o


def test_auto_precision_16bit_uses_fast_and_meets_gate(tmp_path):
    """A 16-bit file under "auto" runs the f32 engine and still lands
    within ~1 LSB @ 16-bit of the float64 oracle (+0.5 LSB output
    quantization)."""
    p, _ = make_input(tmp_path, encoding=Encoding.PCM_16)
    out = tmp_path / "out16.wav"
    m = process_file(p, out, FilterOptions(**_auto_opts()), show_progress=False)
    assert m["precision"] == "fast"

    result = audio.read_audio(out)
    data_in = audio.read_audio(p)
    taps = kd.highpass_taps(100.0 / FS, kd.kernel_length(200.0 / FS))
    for c in range(2):
        ref = oracle.direct_filter(data_in.samples[c], taps)
        assert oracle.max_lsb_error(result.samples[c], ref, bits=16) <= 1.5


def test_auto_precision_24bit_uses_high(tmp_path):
    p, _ = make_input(tmp_path, encoding=Encoding.PCM_24)
    out = tmp_path / "out24.wav"
    m = process_file(p, out, FilterOptions(**_auto_opts()), show_progress=False)
    assert m["precision"] == "high"


def test_streamed_host_residency_no_full_padded_copy():
    """The streaming path must not materialize a third full-payload array
    (the round-3 full zero-padded input copy): with the input preallocated,
    Python-side allocations during streaming are the output (1x payload)
    plus O(segment) staging — well under 2x payload (VERDICT r3 weak #4)."""
    import tracemalloc

    ws = kd.WindowedSinc(0.02, 0.025).make_low_cut()
    plan = osv.make_plan(ws.taps, precision="fast", block_size=1024)
    rng = np.random.default_rng(0)
    n = 40 * plan.hop  # 20 segments of 2 hops each
    x = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    payload = x.nbytes
    # Warm the jit cache so compile-time allocations don't count.
    filter_array_streamed(x[:, : 2 * plan.hop + 7], plan,
                          segment_len=plan.hop * 2)
    tracemalloc.start()
    tracemalloc.reset_peak()
    y, peak = filter_array_streamed(x, plan, segment_len=plan.hop * 2)
    _, peak_bytes = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert y.shape == x.shape
    # out (1x) + a few segment-sized staging/result buffers. The old code's
    # full padded copy alone would push this past 2x.
    assert peak_bytes < 1.6 * payload, (peak_bytes, payload)


@pytest.mark.parametrize("precision,bits", [("fast", 16), ("high", 24)])
def test_streamed_multisegment_equals_single_call(precision, bits):
    """Segment chaining (Mo2 halos, per-segment device peaks) with the
    jnp.fft engine reproduces the single call: different segment shapes
    may round differently in the last float32 bit, so the bound is one
    gate each way, and both stay inside the gate against the oracle."""
    ws = kd.WindowedSinc(0.02, 0.025).make_low_cut()
    plan = osv.make_plan(ws.taps, precision=precision, block_size=1024,
                         engine="fft")
    rng = np.random.default_rng(31)
    x = rng.uniform(-0.7, 0.7, (2, 20_000)).astype(np.float32)
    whole, pw = filter_array_streamed(x, plan)
    seg, ps = filter_array_streamed(x, plan, segment_len=plan.hop * 3)
    assert seg.dtype == np.float32 and seg.shape == x.shape
    assert oracle.max_lsb_error(seg, whole, bits=bits) <= 1.0
    assert np.isclose(pw, ps, rtol=1e-6)
    for c in range(2):
        ref = oracle.direct_filter(x[c], ws.taps)
        for y in (whole, seg):
            assert oracle.max_lsb_error(y[c], ref, bits=bits) <= 1.0


def test_process_file_metrics_name_the_device(tmp_path):
    """The metrics carry the platform and kind of the device that
    filtered, so a run that left the accelerator is visible."""
    import jax

    p, _ = make_input(tmp_path, frames=3000)
    m = process_file(p, tmp_path / "out.wav", FilterOptions(**OPTS),
                     show_progress=False)
    d = jax.devices()[0]
    assert m["device"] == {"platform": d.platform, "kind": d.device_kind,
                           "count": 1}
