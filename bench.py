#!/usr/bin/env python
"""North-star benchmark: filtering throughput in samples/sec/chip.

Headline workload (BASELINE.md): 1-hour 96 kHz stereo WAV, default lowcut
filter (-f 15 -s 10 -> M = 38,400 taps at 96 kHz), high precision. Baseline target: >= 100x faster than realtime on
one chip, i.e. 100 * 96000 frames/s * 2 channels = 1.92e7 samples/s.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "samples/s/chip", "vs_baseline": N}
(vs_baseline = value / 1.92e7; >= 1.0 means the 100x-realtime target is met.)

Extra modes (reports go to stderr; the stdout contract stays one line):
  --all       run the kernels of the 5 BASELINE.json configs
  --roofline  analytic flops/bytes model of the df64 four-step engine
  --fidelity  fidelity gate: production-size engine vs the float64
              oracle, max error in LSB @ 24-bit (BASELINE.md: <= 1.0)
  --e2e       whole-tool wall time: synthesize the 1-h 96 kHz stereo 24-bit
              WAV, time every host stage at full scale, run bin/lowcut
              end-to-end on a short slice for the stage split

Measurement methodology: the metric is the device's filtering throughput —
the full overlap-save pipeline (block unfold, FFT, spectral multiply,
inverse FFT, hop reassembly, edge-exact semantics) executed on
device-resident segments, exactly as the streaming pipeline dispatches
them. Host<->device transfer is excluded from this number. Completion is
fenced with ``block_until_ready``. Every result names the device it ran
on; no device rate is claimed from a CPU run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from lowcut.utils.options import ENGINES


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure_chip_rate(freq: float, slope: float, fs: float, channels: int,
                      precision: str, block_size: int, segment_blocks: int,
                      reps: int, engine: str = "auto",
                      conv_chunk: int = 0) -> dict:
    """Device-resident throughput of one filter configuration."""
    import jax
    import jax.numpy as jnp

    from lowcut.ops import kernel_design as kd
    from lowcut.ops import overlap_save as osv

    rng = np.random.default_rng(0)
    ws = kd.WindowedSinc(freq / fs, slope / fs).make_low_cut()
    plan = osv.make_plan(ws.taps, precision=precision,
                         block_size=block_size, engine=engine,
                         conv_chunk=conv_chunk or osv.CONV_CHUNK)
    seg = segment_blocks * plan.hop
    log(f"kernel: {ws.num_taps} taps (M={ws.m}); block B={plan.block_size}, "
        f"hop {plan.hop}; precision={precision}; engine={engine}")
    log(f"segment: {channels} ch x {seg} frames ({seg / fs:.1f}s of audio) "
        f"+ {plan.m} halo")

    # FFT timing is data-independent, so the segment is generated on the
    # device (deterministic iota+sin): nothing crosses to the device.
    t0 = time.perf_counter()
    xd = jax.jit(lambda: 0.3 * jnp.sin(
        0.37 * jnp.arange(channels * (seg + plan.m), dtype=jnp.float32)
    ).reshape(channels, seg + plan.m))().block_until_ready()
    log(f"generate segment on device: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    osv.extended_filter(xd, plan, seg).block_until_ready()
    log(f"warmup (incl. compile): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    y_last = None
    for _ in range(reps):
        y_last = osv.extended_filter(xd, plan, seg)
    y_last.block_until_ready()
    dt = time.perf_counter() - t0
    assert np.isfinite(np.asarray(y_last[0, :8])).all()
    samples = reps * channels * seg
    chip_rate = samples / dt
    log(f"device-resident: {reps} segments in {dt:.3f}s -> "
        f"{chip_rate/1e6:.1f} Msamples/s "
        f"({chip_rate / (fs * channels):.0f}x realtime)")
    return {"rate": chip_rate, "plan": plan, "num_taps": ws.num_taps,
            "realtime_x": chip_rate / (fs * channels)}


def roofline_report(plan, chip_rate: float) -> None:
    """Analytic cost model of the df64 four-step engine vs what was
    measured (other engines: not modelled).

    Flop weights (f32 ops) for strict double-float arithmetic
    (ops/df64.py): add/sub = 11, mul = 20 -> complex add = 22,
    complex mul = 4*20 + 2*11 = 102. A radix-4 stage does 8 complex
    add/sub + 3 complex mul per 4 points; a radix-2 stage 2 add + 1 mul
    per 2 points. HBM traffic: each fori_loop stage and each
    twiddle/multiply/transpose materializes the [.., B] complex df64
    working set (16 B/point) once read + once written.
    """
    if plan.engine != "fourstep" or plan.precision != "high":
        log(f"roofline model: not modelled for engine={plan.engine} "
            f"precision={plan.precision}")
        return
    from lowcut.ops import fft_core as fc

    b = plan.block_size
    r, c = fc.fourstep_split(b)
    CADD, CMUL = 22.0, 102.0
    W8MUL = 62.0  # omega_8 rotation: complex add + two dconst muls

    def stage_flops(n):
        """Per-point f32-flops and stage count of the DIF plan (radix-8
        greedy, ops/fft_core.py dif_plan). Twiddle muls skipped at d=1."""
        f = 0.0
        stages = fc.dif_plan(n)
        for kind, d in stages:
            ntw = {"r2": 1, "r4": 3, "r8": 7}[kind] if d > 1 else 0
            if kind == "r2":
                f += (2 * CADD + ntw * CMUL) / 2
            elif kind == "r4":
                f += (8 * CADD + ntw * CMUL) / 4
            else:  # r8: 24 cadds + 2 omega_8 rotations + twiddles
                f += (24 * CADD + 2 * W8MUL + ntw * CMUL) / 8
        return f, len(stages)

    f_r, s_r = stage_flops(r)
    f_c, s_c = stage_flops(c)
    # forward + inverse of both phases + 2 four-step twiddle muls + H mul
    flops_per_cplx = 2 * (f_r + f_c) + 3 * CMUL
    stages = 2 * (s_r + s_c)
    # HBM passes: every stage r+w, 2 transposes r+w, 3 pointwise muls fused
    # into adjacent stages (XLA), pack/unpack ~2 passes of f32.
    passes = 2 * (stages + 2)
    bytes_per_cplx = passes * 16.0 + 2 * 8.0
    # two real samples ride one complex point
    flops_per_sample = flops_per_cplx / 2
    bytes_per_sample = bytes_per_cplx / 2
    gflops = chip_rate * flops_per_sample / 1e9
    gbs = chip_rate * bytes_per_sample / 1e9
    log("roofline model (df64 four-step, strict arithmetic):")
    log(f"  B={b} = {r}x{c}; {stages} fori stages fwd+inv")
    log(f"  model: {flops_per_sample:.0f} f32-flop/sample, "
        f"{bytes_per_sample:.0f} HBM B/sample")
    log(f"  achieved at {chip_rate/1e6:.1f} Msamples/s: "
        f"{gflops:.0f} Gflop/s, {gbs:.0f} GB/s device memory")


def fidelity_report(freq: float, slope: float, fs: float, precision: str,
                    block_size: int, engine: str) -> float:
    """Fidelity gate (BASELINE.md: <= 1 LSB @ 24-bit): run the
    PRODUCTION-size engine on device over full-scale random noise spanning
    several overlap-save blocks (both signal edges + an uneven tail) and
    compare against the float64 oracle evaluated on host.

    This is the committed, re-runnable form of the reference's precision
    ladder (reference FilterCore.h:21-23: f64 accumulate -> f32): the
    engine's high-precision path must land within one 24-bit LSB of the
    same-semantics float64 direct convolution.
    """
    import jax.numpy as jnp

    from lowcut.ops import kernel_design as kd
    from lowcut.ops import oracle
    from lowcut.ops import overlap_save as osv

    ws = kd.WindowedSinc(freq / fs, slope / fs).make_low_cut()
    plan = osv.make_plan(ws.taps, precision=precision,
                         block_size=block_size, engine=engine)
    n = 3 * plan.hop + plan.hop // 3  # several blocks + uneven tail
    rng = np.random.default_rng(7)
    # The gate depth matches the precision's PROMISE (the auto policy,
    # utils/options.resolve_precision): "high" serves >16-bit outputs and
    # gates at 24-bit; "fast" serves <=16-bit PCM and gates at 16-bit.
    # The bound is ULP-RELATIVE (<= 1 LSB of the output's binade,
    # fft_core._ArithDF40): the second case drives the output peak into
    # [2, 4) to exercise the scale-following unit — an absolute 1-LSB gate
    # would spuriously fail there on an ulp-exact engine.
    gate_bits = 24 if precision == "high" else 16
    gate_err = 0.0
    for amp, label in ((1.0, "full-scale"), (2.4, "2.4x-scale")):
        x = rng.uniform(-amp, amp, n).astype(np.float32)
        log(f"fidelity: {ws.num_taps} taps, B={plan.block_size}, "
            f"{n} frames {label} noise, precision={precision}, "
            f"engine={engine}")
        t0 = time.perf_counter()
        y = np.asarray(osv.same_filter(jnp.asarray(x), plan))
        log(f"device filter (incl. compile and transfer): "
            f"{time.perf_counter() - t0:.1f}s")
        want = oracle.fft_filter_f64(x, ws.taps)
        err24 = oracle.max_scaled_lsb_error(y, want, bits=24)
        err16 = oracle.max_scaled_lsb_error(y, want, bits=16)
        peak = float(np.abs(want).max())
        err = err24 if gate_bits == 24 else err16
        gate_err = max(gate_err, err)
        log(f"fidelity vs float64 oracle: max err {err24:.3f} "
            f"scale-relative LSB @ 24-bit ({err16:.5f} @ 16-bit), "
            f"output peak {peak:.3f} "
            f"-> gate (<= 1.0 ulp of output scale @ {gate_bits}-bit): "
            f"{'PASS' if err <= 1.0 else 'FAIL'}")
    return gate_err, gate_bits


def e2e_report(log, hours: float = 1.0, device_seconds: float = 30.0) -> bool:
    """Whole-tool wall-time decomposition (the reference's published metric
    is end-to-end batch time, reference Makefile:47-49).

    Host stages (synthesize, container parse + PCM24 decode, PCM24 encode +
    write) are timed AT FULL SCALE (the 1-h 96 kHz stereo 24-bit headline
    file, ~2 GB). The filter stage runs over a short slice via
    ``bin/lowcut --json-metrics``. Returns False if that run failed.
    """
    import shutil
    import subprocess
    import tempfile

    from lowcut import audio
    from lowcut.audio import synth

    fs = 96000.0
    n = int(hours * 3600 * fs)
    tmp = tempfile.mkdtemp(prefix="lowcut_e2e_")

    # Raw-disk probe: whole-tool wall time can be a property of the disk,
    # not the framework; the probe quantifies that bound so the stage
    # numbers below can be read correctly.
    t0 = time.perf_counter()
    blob = b"\x5a" * (64 << 20)
    with open(f"{tmp}/probe", "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    dt = time.perf_counter() - t0
    log(f"e2e: raw disk write {64 / dt:.0f} MB/s "
        f"(64 MiB fsync probe); codec-vs-disk bound applies below")
    os.unlink(f"{tmp}/probe")
    del blob
    try:
        log(f"e2e: synthesizing {hours:g} h 96 kHz stereo 24-bit WAV "
            f"({n} frames, {n * 6 / 1e9:.2f} GB data chunk)")
        t0 = time.perf_counter()
        # Chunked synthesis: the f64 intermediates of a whole-hour
        # np.arange/sin chain alone would be ~8 GB; 2^24-frame chunks keep
        # the transient under ~0.4 GB.
        xs = np.empty((2, n), np.float32)
        for s0 in range(0, n, 1 << 24):
            s1 = min(n, s0 + (1 << 24))
            t = np.arange(s0, s1, dtype=np.float64) / fs
            c = (0.4 * np.sin(2 * np.pi * 220.0 * t)
                 + 0.2 * np.sin(2 * np.pi * 4.0 * t)).astype(np.float32)
            xs[0, s0:s1] = c
            xs[1, s0:s1] = 0.7 * c
        del t, c
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        synth.create_audio_file(f"{tmp}/full.wav", xs, fs,
                                encoding=audio.Encoding.PCM_24)
        t_write = time.perf_counter() - t0
        samples = 2 * n

        t0 = time.perf_counter()
        data = audio.read_audio(f"{tmp}/full.wav")
        t_read = time.perf_counter() - t0
        assert data.samples.shape == (2, n)

        t0 = time.perf_counter()
        audio.write_audio(f"{tmp}/copy.wav", data)
        t_enc = time.perf_counter() - t0

        log(f"e2e host stages at full scale ({samples / 1e6:.0f} Msamples):")
        log(f"  synthesize        : {t_gen:7.2f}s")
        log(f"  encode+write PCM24: {t_write:7.2f}s "
            f"({samples / t_write / 1e6:7.1f} Ms/s)")
        log(f"  parse+decode PCM24: {t_read:7.2f}s "
            f"({samples / t_read / 1e6:7.1f} Ms/s)")
        log(f"  re-encode+write   : {t_enc:7.2f}s "
            f"({samples / t_enc / 1e6:7.1f} Ms/s)")
        # The streaming pipeline (pipeline/stream.py) overlaps read/filter/
        # write, so the whole-tool bound is the slowest stage, not the sum.
        bound = max(t_read, t_enc)
        log(f"  overlapped host-stage bound: {bound:.1f}s = "
            f"{hours * 3600 / bound:.0f}x realtime on this disk")
        # Host residency at 1-h scale: the streaming filter holds input +
        # output + O(segment) staging only (~2x payload, pipeline/stream.py).
        # ru_maxrss here covers the codec stages above (input + raw bytes).
        import resource
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        payload = data.samples.nbytes
        log(f"  host residency: peak RSS {rss / 1e9:.2f} GB over the "
            f"synthesize+codec stages ({rss / payload:.2f}x the "
            f"{payload / 1e9:.2f} GB f32 payload — harness-side; the TOOL's "
            f"streaming filter holds input + output + O(segment) staging, "
            f"<= 2x payload, tracemalloc-gated in "
            f"tests/test_pipeline.py::test_streamed_host_residency...)")
        del data

        if device_seconds <= 0:
            return True
        # Short-slice on-hardware run for the true stage split.
        ns = int(device_seconds * fs)
        synth.create_audio_file(f"{tmp}/short.wav", xs[:, :ns], fs,
                                encoding=audio.Encoding.PCM_24)
        del xs
        log(f"e2e: bin/lowcut on a {device_seconds:g}s slice")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "bin/lowcut", "--json-metrics", "-O",
             f"{tmp}/short.wav", f"{tmp}/short_out.wav"],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            log(f"  lowcut FAILED rc={proc.returncode}: "
                f"{proc.stderr[-500:]}")
            return False
        metrics = None
        for line in proc.stderr.splitlines():
            line = line.strip()
            if line.startswith("{"):
                metrics = json.loads(line)
        log(f"  wall (incl. JAX init + compile): {wall:.1f}s; stages: "
            + json.dumps({k: round(v, 3) for k, v in metrics.items()
                          if isinstance(v, float)})
            + f"; device {metrics.get('device')}")
        return True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The 5 BASELINE.json workload configs, as (name, freq, slope, fs, channels).
# Config 4 (64-file batch) exercises host orchestration, not the chip — its
# chip-side kernel equals config 1; config 5's multi-host sharding is
# validated by tests/test_sharded.py + dryrun_multichip, its chip-side
# kernel is measured here at 192 kHz.
BASELINE_CONFIGS = [
    ("cfg1 mono 44.1k 16-bit, f=20 s=10", 20.0, 10.0, 44100.0, 1),
    ("cfg2 stereo 96k 24-bit, f=10 s=5 (long kernel)", 10.0, 5.0, 96000.0, 2),
    ("cfg3 AIFF, f=40 s=10 + normalize", 40.0, 10.0, 44100.0, 2),
    ("cfg5 stereo 192k, f=15 s=10 (sharded kernel)", 15.0, 10.0, 192000.0, 2),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6,
                    help="device-resident segment passes to time")
    ap.add_argument("--precision", choices=["high", "fast"], default="high")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", *ENGINES])
    ap.add_argument("--freq", type=float, default=15.0)
    ap.add_argument("--slope", type=float, default=10.0)
    ap.add_argument("--sample-rate", type=float, default=96000.0)
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--block-size", type=int, default=0)
    ap.add_argument("--conv-chunk", type=int, default=0,
                    help="blocks per in-jit conv step (0 = engine default)")
    ap.add_argument("--segment-blocks", type=int, default=1008,
                    help="hops per timed segment (default 1008 = ~3.9 min "
                         "of stereo 96 kHz per call; an untuned default)")
    ap.add_argument("--all", action="store_true",
                    help="also run the BASELINE.json config kernels (stderr)")
    ap.add_argument("--roofline", action="store_true",
                    help="print the analytic flops/bytes model (stderr)")
    ap.add_argument("--fidelity", action="store_true",
                    help="run the fidelity gate (stderr; fails the "
                         "process if the 1-LSB@24-bit bound is exceeded)")
    ap.add_argument("--e2e", action="store_true",
                    help="run the whole-tool wall-time decomposition (stderr)")
    ap.add_argument("--e2e-hours", type=float, default=1.0)
    args = ap.parse_args()

    if args.e2e and not e2e_report(log, hours=args.e2e_hours):
        return 1

    import jax

    dev = jax.devices()[0]
    log(f"device: {dev}")

    fs = args.sample_rate
    fidelity_err = None
    if args.fidelity:
        fidelity_err, fidelity_bits = fidelity_report(
            args.freq, args.slope, fs, args.precision, args.block_size,
            args.engine)

    res = measure_chip_rate(args.freq, args.slope, fs, args.channels,
                            args.precision, args.block_size,
                            args.segment_blocks, args.reps, args.engine,
                            args.conv_chunk)
    chip_rate = res["rate"]
    if args.roofline:
        roofline_report(res["plan"], chip_rate)

    if args.all:
        log("\nBASELINE.json config kernels:")
        extra = {}
        for name, f, s, cfs, ch in BASELINE_CONFIGS:
            log(f"--- {name}")
            # Long-kernel configs (B=2^19) at the headline 1008-hop segment
            # would hold ~12 GB resident (in + padded view + out); 504 hops
            # stays within ~2% of the segment-size plateau at half that.
            r = measure_chip_rate(f, s, cfs, ch, args.precision, 0,
                                  min(args.segment_blocks, 504),
                                  max(4, args.reps // 2), args.engine)
            extra[name] = {"samples_per_sec": round(r["rate"], 1),
                           "realtime_x": round(r["realtime_x"], 1)}
        log(json.dumps(extra, indent=2))

    baseline = 100.0 * fs * args.channels  # 100x realtime, in samples/s
    result = {
        "metric": "samples/sec/chip (1h 96kHz stereo WAV, M-tap FIR)",
        "value": round(chip_rate, 1),
        "unit": "samples/s/chip",
        "vs_baseline": round(chip_rate / baseline, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": 1},
    }
    print(json.dumps(result))
    if fidelity_err is not None and fidelity_err > 1.0:
        log(f"FIDELITY GATE FAILED: {fidelity_err:.3f} > 1.0 "
            f"scale-relative LSB @ {fidelity_bits}-bit")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
